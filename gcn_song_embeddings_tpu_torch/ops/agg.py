"""K2: fused neighbor gather + Q-MLP + importance-weighted mean.

    agg[b] = sum_t w[b,t] * leaky_relu(h[nb[b,t]] @ Wq^T + bq)
             / (sum_t w[b,t], or 1 where that sum is 0)

``conv_aggregate`` is the aggregation inside every PinSage conv layer.
For tensors on the CPU it runs ``conv_aggregate_plain`` (gather + einsum,
the JAX package's default path) under PyTorch's own autograd.  For CUDA
tensors it goes through ``ConvAggregate``, whose forward launches the
kernels that ``mode`` names and whose backward carries the gradient to
h, Wq and bq.  Both modes run their products on the tensor cores in
3xTF32 (``csrc/agg_tc.cuh``), as accurate as f32: ``split_wq`` first
splits Wq into TF32 big and small parts, then

- ``"stream"``, K2 (``csrc/agg.cu``): ``project_table`` projects every
  table row once, ``P = leaky_relu(h Wq^T + bq)``, and ``gather_mean``
  takes each node's weighted mean of its neighbors' rows of P (plain
  versions ``project_table_plain`` and ``gather_mean_plain``);
- ``"dma"``, K3 (``csrc/dma_agg.cu``, ``ops/dma_agg.py``): one fused
  kernel over the gathered rows, each block owning whole nodes.

K2 takes any T >= 1; K3 takes T <= 64 (a tile of gathered rows holds
whole nodes: 192 rows in f32, 64 in the 16-bit forms), and both take Din and H in multiples of 4 (16-byte
loads): ``models.pinsage.aggregate`` meets those limits for any width and
T.  With ``block_rows`` K2 projects the table once and gathers the nodes
in blocks of that many rows.  A CUDA call either launches its kernels or
raises: there is no fallback, and no CUDA call returns a tensor that
gradients do not reach.

The 16-bit forms (``train.dtype="bfloat16"`` or ``"float16"``) take a
bf16 or f16 table and a Wq of the same type (bq stays f32), accumulate
in f32 and return f32, as the JAX package's products with
``preferred_element_type=f32`` do; the plain versions upcast the 16-bit
operands (exactly) and multiply in f32.  On CUDA, ``tile_wq16`` lays
Wq out in the tensor cores' tiles without a split and one 16-bit pass
per product runs on the 16-bit core of ``csrc/agg_tc.cuh`` (K2:
``project_table16``, then ``gather_mean``; K3: ``dma_agg.launch16``),
each dispatching on the table's type; Din must then be a
multiple of 8.  Weights may be 16-bit in mode "stream" only (the
full-graph forward's): their sum is taken in f32 and rounded to their
type (``_denominator``), as the JAX package's sum of a 16-bit array is.

Under the matmul precision policy (``utils.precision``,
``GCN_TPU_MATMUL_PRECISION``) an f32 table's product runs as the JAX
package's does on the TPU: one bf16 pass (``default``: bf16(h) bf16(Wq)
summed in f32) or three (``high``: hi*lo + lo*hi + hi*hi of
``bf16_split3``'s parts).  On CUDA those are the "bf16x1" and "bf16x3"
forms of K2 (``project_table_bf16x``, then ``gather_mean``) and K3
(``dma_agg.launch_bf16x``) on the 16-bit core: they read the f32 rows
and round them as the producer stages them, and Wq is tiled once in bf16
(``tile_wq_bf16x``: hi, and lo for three passes); Din must then be a
multiple of 8.  The plain versions take ``passes`` and round the same
operands; ``ConvAggregate.backward`` rounds its recomputed projection
and its products the same way (each gathered row's gradient rounded
before it is summed onto its table row, as the TPU's backward dots
round their cotangent).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gcn_song_embeddings_tpu_torch.ops import cuda_build, dma_agg
from gcn_song_embeddings_tpu_torch.utils import precision

NAME = "agg"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/agg.cu"
HEADER = "gcn_song_embeddings_tpu_torch/csrc/agg_tc.cuh"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_agg.py:52"
MAX_T = 64  # K3's: a tile (192 rows; 16-bit: 64) holds whole nodes
MODES = {"stream": "K2", "dma": "K3"}
BN, BK, SLAB = 128, 32, 64  # Wq tile rows and floats (agg_tc.cuh); P slab
BK16 = 64  # 16-bit elements of a Wq tile row (agg_tc.cuh's 16-bit core)
# the 16-bit table types, each with its form's name and the gather's
# rounding of the weight sum (agg.cu ``den_round``)
SIXTEEN = {torch.bfloat16: ("bf16", 1), torch.float16: ("f16", 2)}
# the forms of an f32 table under the precision policy, by bf16 passes
BF16X = {1: "bf16x1", 3: "bf16x3"}

launches = 0  # K2 op calls on f32 CUDA tables since the last reset
launches_bf16 = 0  # K2 op calls on bf16 CUDA tables since the last reset
launches_f16 = 0  # K2 op calls on f16 CUDA tables since the last reset
# launches of each K2 kernel (the split also runs for every K3 call; the
# gather serves every form)
kernel_launches = {"split": 0, "project": 0, "gather_mean": 0}
# launches of the 16-bit forms' own kernels (the tiling also runs for
# every 16-bit K3 call)
kernel_launches_bf16 = {"tile": 0, "project": 0}
kernel_launches_f16 = {"tile": 0, "project": 0}
# K2 op calls on f32 CUDA tables in one and three bf16 passes, and the
# launches of those forms' own kernels (the tiling also runs for every
# K3 call of the form)
launches_bf16x1 = 0
launches_bf16x3 = 0
kernel_launches_bf16x1 = {"tile": 0, "project": 0}
kernel_launches_bf16x3 = {"tile": 0, "project": 0}
# ConvAggregate.backward calls on CUDA tensors, by forward mode and form
backward_launches = {f"{mode}{form}": 0 for mode in ("stream", "dma")
                     for form in ("", "_bf16", "_f16", "_bf16x1",
                                  "_bf16x3")}
# launches of the yardsticks on CUDA tensors (not port kernels:
# ``l2_read_probe``, ``gather_read_probe``)
probe_launches = {"l2": 0, "gather": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"split": [_P] * 3 + [_I] * 2 + [_P],
             "project": [_P] * 5 + [_I] * 3 + [_P],
             "gather": [_P] * 4 + [_I] * 5 + [_P],
             "tile16": [_P] * 2 + [_I] * 2 + [_P],
             "project16": [_P] * 4 + [_I] * 4 + [_P],
             "tile_bf16x": [_P] * 3 + [_I] * 2 + [_P],
             "project_bf16x": [_P] * 5 + [_I] * 4 + [_P],
             "l2_probe": [_P] + [_I] * 2 + [_P, _I, _P],
             "gather_probe": [_P, _I, _I, _P] + [_I] * 3 + [_P, _I, _P]}


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A 16-bit (bf16 or f16) tensor upcast to f32 (exactly); any other
    as it is."""
    return x.float() if x.dtype in SIXTEEN else x


def _form(dtype: torch.dtype) -> str:
    """The kernels' form for a table type: "bf16", "f16", or "" (f32)."""
    return SIXTEEN[dtype][0] if dtype in SIXTEEN else ""


def _denominator(nb_weights: torch.Tensor) -> torch.Tensor:
    """[B, 1]: each node's weight sum, or 1 where that sum is 0.  Of
    16-bit weights the sum is taken in f32 and rounded to their type, as
    the JAX package's ``nb_w.sum(axis=1)`` of a bf16 or f16 array
    (returned in f32)."""
    if nb_weights.dtype not in SIXTEEN:
        w_sum = nb_weights.sum(dim=1, keepdim=True)
    else:
        w_sum = nb_weights.sum(dim=1, keepdim=True, dtype=torch.float32).to(
            nb_weights.dtype).float()
    return torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)


def conv_aggregate_plain(h: torch.Tensor, nb_nodes: torch.Tensor,
                         nb_weights: torch.Tensor, Wq: torch.Tensor,
                         bq: torch.Tensor, passes: int | None = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: materialized gather, einsum, weighted mean
    (16-bit operands upcast, products and sums in f32; with ``passes``
    the product of the gathered rows and Wq in that many bf16 passes,
    ``matmul``)."""
    nb = h[nb_nodes.reshape(-1).long()].reshape(*nb_nodes.shape, h.shape[1])
    if passes is None:
        prod = torch.einsum("btd,hd->bth", _f32(nb), _f32(Wq))
    else:
        prod = matmul(nb.reshape(-1, h.shape[1]), Wq.t(), passes).reshape(
            *nb_nodes.shape, Wq.shape[0])
    q = F.leaky_relu(prod + _f32(bq), 0.01)
    return ((_f32(nb_weights)[:, :, None] * q).sum(dim=1)
            / _denominator(nb_weights))


def project_table_plain(h: torch.Tensor, Wq: torch.Tensor,
                        bq: torch.Tensor, passes: int | None = None
                        ) -> torch.Tensor:
    """K2's first phase, plain: every table row projected once, [N, H]
    f32 (16-bit operands upcast; with ``passes`` in that many bf16
    passes)."""
    if passes is None:
        return F.leaky_relu(torch.addmm(_f32(bq), _f32(h), _f32(Wq).t()),
                            0.01)
    return F.leaky_relu(matmul(h, Wq.t(), passes) + bq, 0.01)


def gather_mean_plain(proj: torch.Tensor, nb_nodes: torch.Tensor,
                      nb_weights: torch.Tensor) -> torch.Tensor:
    """K2's second phase, plain: the weighted mean of rows of ``proj``
    (16-bit weights: the denominator rounded to their type)."""
    rows = proj[nb_nodes.reshape(-1).long()].reshape(*nb_nodes.shape, -1)
    return ((_f32(nb_weights)[:, :, None] * rows).sum(dim=1)
            / _denominator(nb_weights))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` with the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (big, small), both TF32, big + small = x within 2^-22 of |x|:
    the operand split of the 3xTF32 product."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (8 significant bits), ties to even,
    as XLA's f32 -> bf16 convert, returned in x's type."""
    return x.to(torch.bfloat16).to(x.dtype)


def bf16_split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo) = (bf16(x), bf16(x - hi)), in x's type: the operand
    split of the three-pass (bf16_3x) product."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def _parts(x: torch.Tensor, passes: int) -> tuple[torch.Tensor, ...]:
    return (bf16_round(x),) if passes == 1 else bf16_split3(x)


def _passes_sum(a_parts, b_parts) -> torch.Tensor:
    """hi hi (one pass), or hi lo + lo hi + hi hi (three: the small terms
    first), of operands split by ``_parts``; each product of bf16 values
    is exact in f32, so only the order of the sums is the framework's."""
    if len(a_parts) == 1:
        return a_parts[0] @ b_parts[0]
    (ah, al), (bh, bl) = a_parts, b_parts
    return ah @ bl + al @ bh + ah @ bh


def _passes_product(a: torch.Tensor, b: torch.Tensor, passes: int
                    ) -> torch.Tensor:
    return _passes_sum(_parts(a, passes), _parts(b, passes))


class _PassesMatmul(torch.autograd.Function):
    """a @ b in ``passes`` bf16 passes, with the gradients' products in
    the same passes (XLA's transposed dots keep the forward's precision,
    so the TPU rounds the cotangent too)."""

    @staticmethod
    def forward(ctx, a, b, passes):
        ctx.save_for_backward(a, b)
        ctx.passes = passes
        return _passes_product(a, b, passes)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad[:2]
        da = _passes_product(g, b.t(), ctx.passes) if need_a else None
        db = _passes_product(a.t(), g, ctx.passes) if need_b else None
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor, passes: int | None = None
           ) -> torch.Tensor:
    """a [M, K] @ b [K, N] in f32 (16-bit operands upcast exactly): with
    ``passes`` None as it is, else in that many bf16 passes (1 or 3)
    forward and backward, as the TPU runs an f32 dot at JAX's default
    (1) or ``high`` (3) precision."""
    if passes is None:
        return _f32(a) @ _f32(b)
    _check_passes(passes)
    return _PassesMatmul.apply(_f32(a), _f32(b), passes)


def policy_passes(*operands: torch.Tensor) -> int | None:
    """The bf16 passes the precision policy gives a product of these
    operands: ``precision.PASSES`` where every operand is f32 (or
    float64, which the tests' references run in), else None (a product
    with a 16-bit operand runs as it did)."""
    if any(t.dtype not in (torch.float32, torch.float64) for t in operands):
        return None
    return precision.PASSES


def tile_wq_plain(x: torch.Tensor) -> torch.Tensor:
    """[H, Din] -> the kernels' tile layout [ceil(H/128), ceil(Din/k),
    128, k], k the elements of 128 bytes (32 f32, 64 bf16): tile (i, j)
    holds rows 128i.., columns kj.., zero-padded, with the 16-byte chunk
    c of row r stored at chunk c ^ (r % 8) (the 128-byte swizzle the
    tensor cores read)."""
    per = 16 // x.element_size()              # elements of a 16-byte chunk
    bk = 8 * per
    hdim, din = x.shape
    nt, kt = -(-hdim // BN), -(-din // bk)
    pad = x.new_zeros((nt * BN, kt * bk))
    pad[:hdim, :din] = x
    tiles = pad.reshape(nt, BN, kt, 8, per).permute(0, 2, 1, 3, 4)
    r = torch.arange(BN, device=x.device)
    chunk = torch.arange(8, device=x.device)[None, :] ^ (r % 8)[:, None]
    return tiles[:, :, r[:, None], chunk].reshape(nt, kt, BN, bk)


def slabs_to_rows(proj: torch.Tensor, hdim: int) -> torch.Tensor:
    """``project_table``'s [ceil(H/64), N, 64] slabs -> rows [N, H]."""
    s, n, _ = proj.shape
    return proj.permute(1, 0, 2).reshape(n, s * SLAB)[:, :hdim]


def _launch(entry: str, *args) -> None:
    lib = cuda_build.bind(NAME, _ARGTYPES[entry], f"{entry}_launch")
    dev = torch.device("cuda", torch.cuda.current_device())
    err = getattr(lib, f"{NAME}_{entry}_launch")(
        *args, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, NAME, err)


def _refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{kernel} launched directly records no gradient: "
                         f"call conv_aggregate for inputs that need one")


def _check_tensors(specs) -> None:
    """Each (name, tensor, dtype, dims) of ``specs``: that dtype and number
    of dims, contiguous, on the first tensor's device."""
    dev = specs[0][1].device
    for name, t, dtype, dim in specs:
        if t.device != dev or t.dtype != dtype or t.dim() != dim:
            raise ValueError(f"{name} must be a {dim}-d {dtype} tensor on "
                             f"{dev}, got {t.dim()}-d {t.dtype} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_widths(kernel: str, hdim: int, din: int | None = None,
                  t: int | None = None, max_t: int | None = None,
                  din_multiple: int = 4) -> None:
    if t is not None and max_t is not None and not 1 <= t <= max_t:
        raise ValueError(f"{kernel} takes 1 <= T <= {max_t}, got T={t}")
    if t is not None and t < 1:
        raise ValueError(f"{kernel} takes T >= 1, got T={t}")
    widths = (hdim,) if din is None else (din, hdim)
    if (min(widths) < 1 or hdim % 4
            or (din is not None and din % din_multiple)):
        raise ValueError(f"{kernel} takes Din and H positive multiples of "
                         f"{din_multiple} and 4 (16-byte loads), got "
                         f"Din={din}, H={hdim}")


def _check_aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte "
                             f"loads)")


def _check_cuda(kernel: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{kernel} launches on CUDA tensors, not {dev}")


def _mismatch(**tensors: torch.Tensor) -> ValueError:
    return ValueError("shape mismatch: " + ", ".join(
        f"{name} {list(t.shape)}" for name, t in tensors.items()))


def _tiles_shape(hdim: int, din: int, bk: int = BK
                 ) -> tuple[int, int, int, int]:
    return -(-hdim // BN), -(-din // bk), BN, bk


def _split_wq(Wq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if Wq.data_ptr() % 16:
        Wq = Wq.clone()                       # 16-byte loads
    big = torch.empty(_tiles_shape(*Wq.shape), dtype=torch.float32,
                      device=Wq.device)
    small = torch.empty_like(big)
    with torch.cuda.device(Wq.device):
        _launch("split", Wq.data_ptr(), big.data_ptr(), small.data_ptr(),
                *Wq.shape)
    kernel_launches["split"] += 1
    return big, small


def _project_table(h: torch.Tensor, big: torch.Tensor, small: torch.Tensor,
                   bq: torch.Tensor) -> torch.Tensor:
    n, din = h.shape
    hdim = bq.shape[0]
    proj = torch.empty((-(-hdim // SLAB), n, SLAB), dtype=torch.float32,
                       device=h.device)
    with torch.cuda.device(h.device):
        _launch("project", h.data_ptr(), big.data_ptr(), small.data_ptr(),
                bq.data_ptr(), proj.data_ptr(), n, din, hdim)
    kernel_launches["project"] += 1
    return proj


def _kernel_counts16(dtype: torch.dtype) -> dict:
    return (kernel_launches_bf16 if dtype == torch.bfloat16
            else kernel_launches_f16)


def _tile_wq16(Wq: torch.Tensor) -> torch.Tensor:
    if Wq.data_ptr() % 16:
        Wq = Wq.clone()                       # 16-byte loads
    tiles = torch.empty(_tiles_shape(*Wq.shape, BK16), dtype=Wq.dtype,
                        device=Wq.device)
    with torch.cuda.device(Wq.device):
        _launch("tile16", Wq.data_ptr(), tiles.data_ptr(), *Wq.shape)
    _kernel_counts16(Wq.dtype)["tile"] += 1
    return tiles


def _project_table16(h: torch.Tensor, tiles: torch.Tensor,
                     bq: torch.Tensor) -> torch.Tensor:
    n, din = h.shape
    hdim = bq.shape[0]
    proj = torch.empty((-(-hdim // SLAB), n, SLAB), dtype=torch.float32,
                       device=h.device)
    with torch.cuda.device(h.device):
        _launch("project16", h.data_ptr(), tiles.data_ptr(), bq.data_ptr(),
                proj.data_ptr(), n, din, hdim,
                int(h.dtype == torch.float16))
    _kernel_counts16(h.dtype)["project"] += 1
    return proj


def _kernel_counts_bf16x(passes: int) -> dict:
    return kernel_launches_bf16x1 if passes == 1 else kernel_launches_bf16x3


def _tile_wq_bf16x(Wq: torch.Tensor, passes: int
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    if Wq.data_ptr() % 16:
        Wq = Wq.clone()                       # 16-byte loads
    shape = _tiles_shape(*Wq.shape, BK16)
    hi = torch.empty(shape, dtype=torch.bfloat16, device=Wq.device)
    lo = torch.empty_like(hi) if passes == 3 else None
    with torch.cuda.device(Wq.device):
        _launch("tile_bf16x", Wq.data_ptr(), hi.data_ptr(),
                0 if lo is None else lo.data_ptr(), *Wq.shape)
    _kernel_counts_bf16x(passes)["tile"] += 1
    return hi, lo


def _project_table_bf16x(h: torch.Tensor, hi: torch.Tensor,
                         lo: torch.Tensor | None, bq: torch.Tensor,
                         passes: int) -> torch.Tensor:
    n, din = h.shape
    hdim = bq.shape[0]
    proj = torch.empty((-(-hdim // SLAB), n, SLAB), dtype=torch.float32,
                       device=h.device)
    with torch.cuda.device(h.device):
        _launch("project_bf16x", h.data_ptr(), hi.data_ptr(),
                0 if lo is None else lo.data_ptr(), bq.data_ptr(),
                proj.data_ptr(), n, din, hdim, passes)
    _kernel_counts_bf16x(passes)["project"] += 1
    return proj


def _gather_mean(proj: torch.Tensor, nb_nodes: torch.Tensor,
                 nb_weights: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    b, t = nb_nodes.shape
    den_round = SIXTEEN.get(nb_weights.dtype, ("", 0))[1]
    w = _f32(nb_weights)                      # 16-bit weights upcast exactly
    with torch.cuda.device(out.device):
        _launch("gather", proj.data_ptr(), nb_nodes.data_ptr(),
                w.data_ptr(), out.data_ptr(), b, t, proj.shape[1],
                out.shape[1], den_round)
    kernel_launches["gather_mean"] += 1
    return out


# The three K2 kernels launched one by one, for tests and timing: each
# checks its tensors as ``conv_aggregate_cuda`` does, which calls the
# unchecked forms above.

def split_wq(Wq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Wq [H, Din] f32 on CUDA -> (big, small) in ``tile_wq_plain``'s
    layout, equal bit for bit to ``tile_wq_plain`` of ``tf32_split``."""
    kernel = "the Wq split"
    _refuse_grad(kernel, Wq)
    _check_tensors((("Wq", Wq, torch.float32, 2),))
    _check_widths(kernel, Wq.shape[0], Wq.shape[1])
    _check_cuda(kernel, Wq.device)
    return _split_wq(Wq)


def project_table(h: torch.Tensor, big: torch.Tensor, small: torch.Tensor,
                  bq: torch.Tensor) -> torch.Tensor:
    """K2's projection on CUDA: P = leaky_relu(h Wq^T + bq) for every row
    of h [N, Din], as [ceil(H/64), N, 64] slabs (``slabs_to_rows``), from
    ``split_wq``'s parts of Wq [H, Din]."""
    kernel = "K2's projection"
    _refuse_grad(kernel, h, big, small, bq)
    _check_tensors((("h", h, torch.float32, 2), ("big", big, torch.float32, 4),
                    ("small", small, torch.float32, 4),
                    ("bq", bq, torch.float32, 1)))
    (n, din), hdim = h.shape, bq.shape[0]
    if big.shape != small.shape or big.shape != _tiles_shape(hdim, din):
        raise _mismatch(h=h, big=big, small=small, bq=bq)
    _check_widths(kernel, hdim, din)
    if n == 0:
        raise ValueError("h has no rows to project")
    _check_aligned(h=h, big=big, small=small)
    _check_cuda(kernel, h.device)
    return _project_table(h, big, small, bq)


def gather_mean(proj: torch.Tensor, nb_nodes: torch.Tensor,
                nb_weights: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K2's gather on CUDA: out [B, H] = the weighted mean of the rows of
    ``project_table``'s slabs [ceil(H/64), N, 64] that nb_nodes [B, T]
    int32 names (ids in [0, N)); of 16-bit weights with the denominator
    rounded to their type."""
    kernel = "K2's gather-mean"
    _refuse_grad(kernel, proj, nb_weights, out)
    _check_weights(kernel, nb_weights, sixteen_ok=True)
    _check_tensors((("proj", proj, torch.float32, 3),
                    ("nb_nodes", nb_nodes, torch.int32, 2),
                    ("nb_weights", nb_weights, nb_weights.dtype, 2),
                    ("out", out, torch.float32, 2)))
    (b, t), hdim = nb_nodes.shape, out.shape[1]
    if (nb_weights.shape != nb_nodes.shape or out.shape[0] != b
            or proj.shape[0] != -(-hdim // SLAB) or proj.shape[2] != SLAB):
        raise _mismatch(proj=proj, nb_nodes=nb_nodes, nb_weights=nb_weights,
                        out=out)
    _check_widths(kernel, hdim, t=t)
    if b and proj.shape[1] == 0:
        raise ValueError("proj has no rows for nb_nodes to name")
    _check_aligned(proj=proj, out=out)
    _check_cuda(kernel, out.device)
    return _gather_mean(proj, nb_nodes, nb_weights, out)


def l2_read_probe(src: torch.Tensor, passes: int) -> torch.Tensor:
    """Not a port kernel: read the f32 tensor ``src`` (contiguous)
    ``passes`` times through L2 on CUDA, as a yardstick.  A ``src`` that
    L2 holds gives the rate at which this card's L2 serves
    ``gather_mean``'s reads; one larger than L2 (50 MB on the H100)
    streams from device memory every pass, so the time of a pass is the
    card's streaming read rate for its bytes (``bench.measure_stream_bw``).
    Returns each thread's sum of what it read."""
    _check_tensors((("src", src, torch.float32, src.dim()),))
    if src.numel() % 4 or src.numel() == 0 or passes < 1:
        raise ValueError("src must hold a positive multiple of 4 floats "
                         "and passes be >= 1")
    _check_aligned(src=src)
    _check_cuda("the L2 read probe", src.device)
    blocks = 8 * torch.cuda.get_device_properties(
        src.device).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        _launch("l2_probe", src.data_ptr(), src.numel() // 4, passes,
                sink.data_ptr(), blocks)
    probe_launches["l2"] += 1
    return sink


def gather_read_probe_plain(table: torch.Tensor, idx: torch.Tensor,
                            reps: int) -> torch.Tensor:
    """``gather_read_probe``'s function: the sum, in f32, of the rows
    ``(idx + r) % N`` of ``table`` [N, d] over r < ``reps`` (0-d f32)."""
    ids = idx.long()
    total = table.new_zeros((), dtype=torch.float32)
    for r in range(reps):
        total = total + table[(ids + r) % table.shape[0]].sum(
            dtype=torch.float32)
    return total


def gather_read_probe(table: torch.Tensor, idx: torch.Tensor,
                      reps: int) -> torch.Tensor:
    """Not a port kernel: ``reps`` gathers of the rows ``(idx + r) % N``
    of the f32 or bf16 ``table`` [N, d] (rows of a multiple of 16
    bytes), summed to a 0-d f32 tensor without writing the rows back, as
    a yardstick for the row rate of the full-graph step's gathers (the
    port's counterpart of ``bench.py``'s ``measure_gather_rates``).  On
    CUDA it launches ``gather_probe_kernel`` (``csrc/agg.cu``), one warp
    a row; on the CPU it runs ``gather_read_probe_plain``."""
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table must be f32 or bf16, got {table.dtype}")
    _check_tensors((("table", table, table.dtype, 2),
                    ("idx", idx, torch.int32, 1)))
    n, d = table.shape
    if n == 0 or idx.numel() == 0 or reps < 1:
        raise ValueError("table and idx must not be empty and reps be >= 1")
    if table.device.type == "cpu":
        return gather_read_probe_plain(table, idx, reps)
    row_bytes = d * table.element_size()
    if row_bytes % 16:
        raise ValueError(f"a table row must be a multiple of 16 bytes, "
                         f"got {row_bytes}")
    _check_aligned(table=table)
    _check_cuda("the gather probe", table.device)
    blocks = 8 * torch.cuda.get_device_properties(
        table.device).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.float32,
                       device=table.device)
    with torch.cuda.device(table.device):
        _launch("gather_probe", table.data_ptr(), n, row_bytes // 16,
                idx.data_ptr(), idx.numel(), reps,
                int(table.dtype == torch.bfloat16), sink.data_ptr(), blocks)
    probe_launches["gather"] += 1
    return sink.sum()


def _sixteen(name: str, t: torch.Tensor) -> torch.dtype:
    if t.dtype not in SIXTEEN:
        raise ValueError(f"{name} must be a bf16 or f16 tensor, got "
                         f"{t.dtype}")
    return t.dtype


def tile_wq16(Wq: torch.Tensor) -> torch.Tensor:
    """Wq [H, Din] bf16 or f16 on CUDA -> the 16-bit kernels' tiles, of
    Wq's type, equal bit for bit to ``tile_wq_plain(Wq)``."""
    dtype = _sixteen("Wq", Wq)
    kernel = f"the {SIXTEEN[dtype][0]} Wq tiling"
    _refuse_grad(kernel, Wq)
    _check_tensors((("Wq", Wq, dtype, 2),))
    _check_widths(kernel, Wq.shape[0], Wq.shape[1], din_multiple=8)
    _check_cuda(kernel, Wq.device)
    return _tile_wq16(Wq)


def project_table16(h: torch.Tensor, tiles: torch.Tensor,
                    bq: torch.Tensor) -> torch.Tensor:
    """K2's 16-bit projection on CUDA: P = leaky_relu(h Wq^T + bq) in f32
    for every row of h [N, Din] bf16 or f16, as [ceil(H/64), N, 64]
    slabs, from ``tile_wq16``'s tiles of Wq [H, Din] (h's type) and bq
    [H] f32."""
    dtype = _sixteen("h", h)
    kernel = f"K2's {SIXTEEN[dtype][0]} projection"
    _refuse_grad(kernel, h, bq)
    _check_tensors((("h", h, dtype, 2), ("tiles", tiles, dtype, 4),
                    ("bq", bq, torch.float32, 1)))
    (n, din), hdim = h.shape, bq.shape[0]
    if tiles.shape != _tiles_shape(hdim, din, BK16):
        raise _mismatch(h=h, tiles=tiles, bq=bq)
    _check_widths(kernel, hdim, din, din_multiple=8)
    if n == 0:
        raise ValueError("h has no rows to project")
    _check_aligned(h=h, tiles=tiles)
    _check_cuda(kernel, h.device)
    return _project_table16(h, tiles, bq)


def _check_passes(passes) -> None:
    if passes not in BF16X:
        raise ValueError(f"passes must be 1 or 3, got {passes!r}")


def tile_wq_bf16x(Wq: torch.Tensor, passes: int
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Wq [H, Din] f32 on CUDA -> its bf16 tiles for ``passes`` bf16
    passes: (hi, None) for one, (hi, lo) for three, equal bit for bit to
    ``tile_wq_plain`` of ``bf16_round(Wq)`` (and of ``bf16_split3``'s lo)
    in bf16."""
    _check_passes(passes)
    kernel = f"the {BF16X[passes]} Wq tiling"
    _refuse_grad(kernel, Wq)
    _check_tensors((("Wq", Wq, torch.float32, 2),))
    _check_widths(kernel, Wq.shape[0], Wq.shape[1], din_multiple=8)
    _check_cuda(kernel, Wq.device)
    return _tile_wq_bf16x(Wq, passes)


def project_table_bf16x(h: torch.Tensor, hi: torch.Tensor,
                        lo: torch.Tensor | None, bq: torch.Tensor,
                        passes: int) -> torch.Tensor:
    """K2's projection of an f32 table in ``passes`` bf16 passes on
    CUDA: P = leaky_relu(h Wq^T + bq) in f32 for every row of h [N, Din]
    f32, each row rounded as it is loaded, as [ceil(H/64), N, 64] slabs,
    from ``tile_wq_bf16x``'s tiles of Wq [H, Din] and bq [H] f32."""
    _check_passes(passes)
    kernel = f"K2's {BF16X[passes]} projection"
    _refuse_grad(kernel, h, bq)
    parts = (("hi", hi), ("lo", lo))[:1 if passes == 1 else 2]
    if passes == 1 and lo is not None:
        raise ValueError("one bf16 pass takes no lo tiles")
    _check_tensors((("h", h, torch.float32, 2),
                    *((name, t, torch.bfloat16, 4) for name, t in parts),
                    ("bq", bq, torch.float32, 1)))
    (n, din), hdim = h.shape, bq.shape[0]
    if any(t.shape != _tiles_shape(hdim, din, BK16) for _, t in parts):
        raise _mismatch(h=h, bq=bq, **dict(parts))
    _check_widths(kernel, hdim, din, din_multiple=8)
    if n == 0:
        raise ValueError("h has no rows to project")
    _check_aligned(h=h, **dict(parts))
    _check_cuda(kernel, h.device)
    return _project_table_bf16x(h, hi, lo, bq, passes)


def _check_weights(kernel: str, nb_weights: torch.Tensor,
                   sixteen_ok: bool) -> None:
    ok = (torch.float32, *SIXTEEN) if sixteen_ok else (torch.float32,)
    if nb_weights.dtype not in ok:
        raise ValueError(f"{kernel} takes nb_weights in "
                         f"{' or '.join(map(str, ok))}, got "
                         f"{nb_weights.dtype}")


def conv_aggregate_cuda(h: torch.Tensor, nb_nodes: torch.Tensor,
                        nb_weights: torch.Tensor, Wq: torch.Tensor,
                        bq: torch.Tensor, mode: str = "stream",
                        block_rows: int | None = None,
                        passes: int | None = None) -> torch.Tensor:
    """Launch K2 (mode "stream") or K3 (mode "dma") on CUDA tensors: h
    [N, Din] f32, bf16 or f16, nb_nodes [B, T] int32 (ids in [0, N)),
    nb_weights [B, T] f32 (or 16-bit in mode "stream"), Wq [H, Din] of
    h's type, bq [H] f32 -> [B, H] f32.  A 16-bit h runs the kernel's
    form of that type; an f32 h with ``passes`` (1 or 3) the form that
    rounds it to bf16 as it loads it (Din a multiple of 8).  K2 projects
    the table once, then gathers all B nodes, or with ``block_rows`` one
    block of that many nodes at a time (the projection is freed on
    return).  Records no graph, so it refuses inputs that need a
    gradient: ``conv_aggregate`` is the differentiable entry."""
    global launches, launches_bf16, launches_f16
    global launches_bf16x1, launches_bf16x3
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    kernel = MODES[mode]
    sixteen = h.dtype in SIXTEEN
    if passes is not None:
        _check_passes(passes)
        if sixteen:
            raise ValueError("bf16 passes apply to f32 tables; a 16-bit "
                             "table runs its own form")
    table_dtype = h.dtype if sixteen else torch.float32
    _refuse_grad(kernel, h, nb_weights, Wq, bq)
    _check_weights(kernel, nb_weights, sixteen_ok=mode == "stream")
    if sixteen and Wq.dtype != h.dtype:
        raise ValueError(f"h must be a 2-d tensor of Wq's type: got h "
                         f"{h.dtype}, Wq {Wq.dtype}")
    _check_tensors((("h", h, table_dtype, 2),
                    ("nb_nodes", nb_nodes, torch.int32, 2),
                    ("nb_weights", nb_weights, nb_weights.dtype, 2),
                    ("Wq", Wq, table_dtype, 2),
                    ("bq", bq, torch.float32, 1)))
    b, t = nb_nodes.shape
    din, hdim = h.shape[1], Wq.shape[0]
    if (nb_weights.shape != nb_nodes.shape or Wq.shape[1] != din
            or bq.shape[0] != hdim):
        raise _mismatch(h=h, nb_nodes=nb_nodes, nb_weights=nb_weights, Wq=Wq,
                        bq=bq)
    _check_widths(kernel, hdim, din, t, MAX_T if mode == "dma" else None,
                  din_multiple=8 if sixteen or passes else 4)
    _check_aligned(h=h)
    _check_cuda(kernel, h.device)
    out = torch.empty((b, hdim), dtype=torch.float32, device=h.device)
    if b == 0:
        return out
    if h.shape[0] == 0:
        raise ValueError("h has no rows for nb_nodes to name")
    if sixteen:
        tiles = _tile_wq16(Wq)
        if mode == "dma":
            dma_agg.launch16(h, nb_nodes, nb_weights, tiles, bq, out)
            return out
        proj = _project_table16(h, tiles, bq)
    elif passes:
        hi, lo = _tile_wq_bf16x(Wq, passes)
        if mode == "dma":
            dma_agg.launch_bf16x(h, nb_nodes, nb_weights, hi, lo, bq, out,
                                 passes)
            return out
        proj = _project_table_bf16x(h, hi, lo, bq, passes)
    else:
        big, small = _split_wq(Wq)
        if mode == "dma":
            dma_agg.launch(h, nb_nodes, nb_weights, big, small, bq, out)
            return out
        proj = _project_table(h, big, small, bq)
    step = block_rows or b
    for s in range(0, b, step):
        _gather_mean(proj, nb_nodes[s:s + step], nb_weights[s:s + step],
                     out[s:s + step])
    if h.dtype == torch.bfloat16:
        launches_bf16 += 1
    elif h.dtype == torch.float16:
        launches_f16 += 1
    elif passes == 1:
        launches_bf16x1 += 1
    elif passes == 3:
        launches_bf16x3 += 1
    else:
        launches += 1
    return out


class ConvAggregate(torch.autograd.Function):
    """The aggregation with a gradient for h, Wq and bq.

    Forward: the kernel ``mode`` names on CUDA tensors, the plain version
    on CPU tensors.  Backward, in plain PyTorch (the JAX package's gradient
    is XLA's autodiff of the gather + einsum; no TPU kernel has a
    backward), in table form: every table row is projected once
    (``P = h Wq^T + bq``, N rows) and gathered (``pre = P[nb]``), the row
    gradients ``dpre = (w / denom) * dagg * leaky_relu'(pre)`` are summed
    onto the table rows they came from (``S = index_add_(nb, dpre)``, a
    few terms per row), and then ``dWq = S^T h``, ``dbq = sum S`` and
    ``dh = S Wq`` are matrix products over the N table rows, not over the
    B*T gathered ones: the same gradient, with reductions T-fold shorter
    where ids repeat (the full-graph forward) and about as long where
    they do not (the frontier forward, whose table holds B*T + B rows).
    The neighbor weights get no gradient: they are constants of the
    neighborhood cache.  For a 16-bit (bf16 or f16) table and Wq the
    pre-activation is recomputed from their f32 upcasts (the JAX
    package's residual is f32: a 16-bit ``addmm`` would round it and move
    the leaky_relu's branch), and dh and dWq are returned in the table's
    type.  dh sums each table row's gradient in f32 and rounds once,
    where JAX's scatter-add (and the CPU path's autograd through the
    plain version) rounds each gathered row's gradient and accumulates
    in 16 bits: a deliberate divergence, the once-rounded sum being the
    more accurate (``tests/test_torch_f16_gpu.py`` pins it on the
    card).  With ``passes`` (an f32 table under the precision policy)
    the recomputed projection runs in the forward's bf16 passes, so the
    leaky_relu takes the forward's branch, and each gathered row's
    gradient is rounded (one pass) or split (three) before it is summed
    onto its table row: ``dh`` and ``dWq`` are then the sums of the
    TPU's backward dots, which round their cotangent, in another order;
    ``dbq`` sums the unrounded rows."""

    @staticmethod
    def forward(ctx, h, nb_nodes, nb_weights, Wq, bq, mode, block_rows=None,
                passes=None):
        if h.device.type == "cpu":
            out = conv_aggregate_plain(h, nb_nodes, nb_weights, Wq, bq,
                                       passes)
        else:
            out = conv_aggregate_cuda(h, nb_nodes, nb_weights, Wq, bq, mode,
                                      block_rows, passes)
        ctx.save_for_backward(h, nb_nodes, nb_weights, Wq, bq)
        ctx.mode, ctx.passes = mode, passes
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dagg):
        h, nb_nodes, nb_weights, Wq, bq = ctx.saved_tensors
        need_h, _, _, need_wq, need_bq = ctx.needs_input_grad[:5]
        passes = ctx.passes
        h32, wq32 = _f32(h), _f32(Wq)
        ids = nb_nodes.reshape(-1).long()
        if passes is None:
            proj = torch.addmm(bq, h32, wq32.t())            # [N, H]
        else:
            proj = _passes_product(h32, wq32.t(), passes) + bq
        pre = proj[ids]                                       # [B*T, H]
        dq = ((_f32(nb_weights) / _denominator(nb_weights))[:, :, None]
              * dagg[:, None, :]).reshape(pre.shape)
        dpre = torch.where(pre >= 0.0, dq, 0.01 * dq)
        if passes is None:
            s = torch.zeros_like(proj).index_add_(0, ids, dpre)  # [N, H]
            dh = (s @ wq32).to(h.dtype) if need_h else None
            dwq = (s.t() @ h32).to(Wq.dtype) if need_wq else None
            dbq = s.sum(dim=0) if need_bq else None
        else:
            s = [torch.zeros_like(proj).index_add_(0, ids, d)
                 for d in _parts(dpre, passes)]
            dh = _passes_sum(s, _parts(wq32, passes)) if need_h else None
            dwq = (_passes_sum([x.t() for x in s], _parts(h32, passes))
                   if need_wq else None)
            dbq = dpre.sum(dim=0) if need_bq else None
        if dagg.device.type == "cuda":
            form = _form(h.dtype) or BF16X.get(passes, "")
            backward_launches[ctx.mode + (f"_{form}" if form else "")] += 1
        return dh, None, None, dwq, dbq, None, None, None


def conv_aggregate(h: torch.Tensor, nb_nodes: torch.Tensor,
                   nb_weights: torch.Tensor, Wq: torch.Tensor,
                   bq: torch.Tensor, mode: str = "stream",
                   block_rows: int | None = None) -> torch.Tensor:
    """Importance-weighted neighbor aggregation [B, H]: on CUDA tensors
    through ``ConvAggregate`` (K2 for mode "stream", K3 for "dma"), on CPU
    tensors the plain version (both modes: they compute one function).
    ``block_rows`` bounds the nodes aggregated at once: K2 still projects
    the table once; the plain version gathers one block at a time.  An
    f32 h and Wq take the precision policy's bf16 passes
    (``policy_passes``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    passes = policy_passes(h, Wq)
    if h.device.type == "cpu":
        if not block_rows or block_rows >= nb_nodes.shape[0]:
            return conv_aggregate_plain(h, nb_nodes, nb_weights, Wq, bq,
                                        passes)
        return torch.cat([
            conv_aggregate_plain(h, nb_nodes[s:s + block_rows],
                                 nb_weights[s:s + block_rows], Wq, bq,
                                 passes)
            for s in range(0, nb_nodes.shape[0], block_rows)])
    if h.device.type != "cuda":
        raise ValueError(f"{MODES[mode]} runs on CUDA or CPU tensors, not "
                         f"{h.device}")
    if nb_weights.requires_grad and torch.is_grad_enabled():
        raise ValueError("nb_weights get no gradient on CUDA (constants of "
                         "the neighborhood cache): pass them detached")
    return ConvAggregate.apply(h, nb_nodes.to(torch.int32).contiguous(),
                               nb_weights.contiguous(), Wq.contiguous(),
                               bq.contiguous(), mode, block_rows, passes)
