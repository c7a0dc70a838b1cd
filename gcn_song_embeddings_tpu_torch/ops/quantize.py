"""int8 embedding tables with per-row scales, and scoring on them.

A row is stored as ``round(x / s)`` clipped to +-127, with ``s`` its
absolute maximum over 127 (1 for a zero row).  Scores ``q . (v * s)``
keep each candidate's order under a positive per-row scale, so top-k
quality moves only by rounding, and the table takes a quarter of the f32
bytes.

Bit for bit the jitted JAX functions of the same names:

* ``absmax / 127`` is computed as ``absmax * f32(1/127)``: XLA compiles
  the division by the constant into that multiply, and a true divide
  differs from it in the last bit of some scales.  ``x / s`` stays a true
  divide (XLA keeps it), and ``torch.round`` rounds half to even as
  ``jnp.round`` does.
* The int8 x int8 product accumulates in int32 (``torch._int_mm``), which
  is exact; its f32 reading is exact too while ``127^2 * d < 2^24``
  (``d <= MAX_DIM``), and the scales are applied in JAX's order,
  ``acc * scales[None, :] * q_scale``.

The product is a library call, as the JAX package leaves it to XLA
outside any Pallas kernel.  On CUDA, ``_int_mm`` takes a first operand of
more than 16 rows and inner and output widths in multiples of 8: the
query batch is padded to a bucket of at least 32 rows, and a serving
table is padded once (``pad_table``) to rows and columns in multiples of
8.  Its second operand is ``values.t()``, the [d, N] column-major view of
the row-major table, which cuBLAS's int8 product takes as it is, so no
transposed copy is made; on the H100 it also takes a row-major [d, N]
copy, with the same sums (``tests/test_torch_kernels_gpu.py``).

The stochastic quantizer, kernel K4, is ``ops.quant_kernel``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INV_127 = 1.0 / 127.0  # applied to f32 tensors: f32(1/127), as XLA folds it
MAX_DIM = 1040         # 127^2 * 1040 < 2^24: the f32 reading of acc is exact
MIN_ROWS_CUDA = 32     # _int_mm on CUDA takes more than 16 rows


def row_scales(absmax: torch.Tensor) -> torch.Tensor:
    """Per-row scale ``absmax / 127`` (1 where the row is all zero)."""
    return torch.where(absmax == 0, 1.0, absmax * INV_127)


def quantize_rows(emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, d] f32 -> (values int8 [N, d], scales f32 [N]), rounded to the
    nearest level (half to even)."""
    scale = row_scales(emb.abs().amax(dim=1))
    q = torch.clamp(torch.round(emb / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _up8(x: int) -> int:
    return -(-x // 8) * 8


def pad_table(values: torch.Tensor, scales: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """An int8 table with its rows and columns padded with zeros to
    multiples of 8 (the shapes ``_int_mm`` takes on CUDA).  A padding row
    has scale 0, so it scores exactly 0; callers drop its columns."""
    n, d = values.shape
    rows, cols = _up8(n) - n, _up8(d) - d
    if rows or cols:
        values = F.pad(values, (0, cols, 0, rows))
        scales = F.pad(scales, (0, rows))
    return values, scales


def int8_matmul(q_int: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """q_int [B, d] int8 . values [N, d'] int8 (d' >= d, zero past d) ->
    [B, N] int32, accumulated exactly."""
    b, d = q_int.shape
    n, dv = values.shape
    if dv < d:
        raise ValueError(f"query width {d} exceeds the table's {dv}")
    if q_int.device.type == "cuda":
        if n % 8 or dv % 8:                        # an unpadded table
            values = F.pad(values, (0, _up8(dv) - dv, 0, _up8(n) - n))
            dv = values.shape[1]
        bucket = max(MIN_ROWS_CUDA, 1 << (b - 1).bit_length())
        q_int = F.pad(q_int, (0, dv - d, 0, bucket - b))
    elif dv != d:
        q_int = F.pad(q_int, (0, dv - d))
    return torch._int_mm(q_int, values.t())[:b, :n]


def int8_scores(values: torch.Tensor, scales: torch.Tensor,
                query: torch.Tensor) -> torch.Tensor:
    """[B, N] similarity scores under the serving index's int8 math.

    values [N, d'] int8 (d' >= d, zero columns past d as ``pad_table``
    makes them), scales [N] f32, query [B, d] f32 (unit rows for cosine).
    The query is quantized row-wise as the table is; its own scale is
    shared by every candidate, so it does not change the ranking."""
    d = query.shape[1]
    if d > MAX_DIM:
        raise ValueError(f"int8 scoring takes d <= {MAX_DIM} (an exact f32 "
                         f"reading of the int32 sum), got d={d}")
    q_scale = row_scales(query.abs().amax(dim=1, keepdim=True))
    q_int = torch.clamp(torch.round(query / q_scale), -127, 127)
    acc = int8_matmul(q_int.to(torch.int8), values)
    return acc.float() * scales[None, :] * q_scale


def int8_topk(values: torch.Tensor, scales: torch.Tensor,
              query: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``q . dequant(row)`` over an int8 table (see
    ``int8_scores``): (scores [B, k] f32, rows [B, k] int64)."""
    return torch.topk(int8_scores(values, scales, query), k, dim=1)
