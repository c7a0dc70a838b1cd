"""K4: the stochastic int8 row quantizer as a CUDA kernel (``csrc/quant.cu``).

``quantize_rows_stochastic(emb, seed)`` is the counterpart of the JAX
package's ``quantize_rows_pallas``: per-row scales as ``ops.quantize.
quantize_rows`` computes them, each value rounded down or up with
probability equal to its fraction, so the rounding is unbiased.  For
tensors on the CPU it runs ``quantize_rows_stochastic_plain``; for CUDA
tensors it launches the kernel, or raises: there is no fallback.

The random bits are a counter-based hash of (seed, row, column), written
out in both versions (``random_bits``), so the kernel equals its plain
version bit for bit.  They are not the TPU's bits: the JAX kernel draws
from the TPU's own generator, so the two packages agree in distribution
(the contract of ``tests/test_quantize.py``), not value by value.

Serving does not round stochastically: the int8 index quantizes with the
round-to-nearest ``quantize_rows``, as the JAX package's does.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_song_embeddings_tpu_torch.ops import cuda_build
from gcn_song_embeddings_tpu_torch.ops.quantize import row_scales

NAME = "quant"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/quant.cu"
REPLACES = "gcn_song_embeddings_tpu/ops/quantize.py:42"

launches = 0  # kernel launches (not plain-version calls) since the last reset

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_uint, ctypes.c_void_p]
_M32 = 0xFFFFFFFF


def _fmix32_int(h: int) -> int:
    """murmur3's 32-bit finalizer on a Python int."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def seed_key(seed: int) -> int:
    """The 32-bit key both versions derive from ``seed``."""
    return _fmix32_int((int(seed) & _M32) ^ 0x9E3779B9)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): c is split into 16-bit
    halves, since h * c itself would overflow int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def random_bits(seed: int, n: int, d: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """[n, d] int64 holding 32 random bits per element:
    ``fmix32(fmix32(row ^ key) ^ column)``, as the kernel computes them."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    return _fmix32(_fmix32(rows ^ seed_key(seed)) ^ cols)


def _check(emb: torch.Tensor) -> None:
    if emb.dtype != torch.float32 or emb.dim() != 2:
        raise ValueError(f"K4 takes a 2-d float32 table, got "
                         f"{emb.dim()}-d {emb.dtype}")
    if emb.shape[1] % 4 or emb.shape[1] == 0:
        raise ValueError(f"K4 takes d a positive multiple of 4 (float4 "
                         f"loads, char4 stores), got d={emb.shape[1]}")
    if emb.shape[0] >= 2 ** 31:
        raise ValueError("K4 indexes rows with int32")


def quantize_rows_stochastic_plain(emb: torch.Tensor, seed: int = 0
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: [N, d] f32 -> (values int8 [N, d],
    scales f32 [N]), on the tensor's own device."""
    _check(emb)
    n, d = emb.shape
    scale = row_scales(emb.abs().amax(dim=1))
    y = emb / scale[:, None]
    u = (random_bits(seed, n, d, emb.device) >> 8).to(torch.float32) \
        * 2.0 ** -24
    low = torch.floor(y)
    q = low + (u < y - low).to(torch.float32)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def quantize_rows_cuda(emb: torch.Tensor, seed: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on a contiguous, 16-byte aligned CUDA table."""
    global launches
    _check(emb)
    if emb.device.type != "cuda":
        raise ValueError(f"K4 launches on CUDA tensors, not {emb.device}")
    if not emb.is_contiguous() or emb.data_ptr() % 16:
        raise ValueError("emb must be contiguous and 16-byte aligned")
    n, d = emb.shape
    values = torch.empty((n, d), dtype=torch.int8, device=emb.device)
    scales = torch.empty((n,), dtype=torch.float32, device=emb.device)
    if n == 0:
        return values, scales
    lib = cuda_build.bind(NAME, _ARGTYPES)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.quant_launch(emb.data_ptr(), values.data_ptr(),
                               scales.data_ptr(), n, d, seed_key(seed),
                               stream)
    cuda_build.check(lib, NAME, err)
    launches += 1
    return values, scales


def quantize_rows_stochastic(emb: torch.Tensor, seed: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastically rounded int8 rows with per-row scales: K4 on CUDA
    tensors, the plain version on CPU tensors."""
    if emb.device.type == "cpu":
        return quantize_rows_stochastic_plain(emb, seed)
    return quantize_rows_cuda(emb, seed)
