"""K1: the restart-walk hop as a CUDA kernel (``csrc/walk.cu``).

``restart_walks`` has the signature of ``ops.walks.walks_from_fused_tables``
(its plain version).  For tensors on the CPU it runs that plain version;
for CUDA tensors it launches the kernel, or raises: there is no fallback.
Under the same uniforms the kernel's trace equals the plain version's
bit for bit (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes

import torch

from gcn_song_embeddings_tpu_torch.ops import cuda_build
from gcn_song_embeddings_tpu_torch.ops.walks import (
    Tables,
    _check_uniforms,
    chain_origins,
    draw_uniforms,
    walks_from_fused_tables,
)

NAME = "walk"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/walk.cu"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_walk.py:75"

launches = 0  # kernel launches (not plain-version calls) since the last reset

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]


def walk_hops_cuda(tables: Tables, origins: torch.Tensor,
                   uniforms: torch.Tensor, alpha: float) -> torch.Tensor:
    """Launch K1: trace [hops, B] int32 for walkers starting at ``origins``
    [B] under ``uniforms`` [hops, B, 3] f32 (all on one CUDA device).  One
    thread per (hop, walker); the threads whose hop starts a restart
    segment walk it, so the segments of every walker run in parallel."""
    global launches
    origin_ext, i2c_ext, c2i_ext = tables
    hops, b = uniforms.shape[0], origins.shape[0]
    _check_uniforms(uniforms, hops, b)
    dev = uniforms.device
    for name, t, width in (("origin_ext", origin_ext, 2),
                           ("i2c_ext", i2c_ext, 2), ("c2i_ext", c2i_ext, 3),
                           ("origins", origins, None)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if width is not None and (t.dim() != 2 or t.shape[1] != width):
            raise ValueError(f"{name} must be [n, {width}], got "
                             f"{list(t.shape)}")
    if not uniforms.is_contiguous():
        raise ValueError("uniforms must be contiguous")
    for name, t in (("origin_ext", origin_ext), ("i2c_ext", i2c_ext)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned (K1 reads its "
                             f"records as int2)")
    if max(i2c_ext.shape[0], c2i_ext.shape[0]) >= 2 ** 31:
        raise ValueError("edge tables past 2^31 rows: K1 indexes int32")
    trace = torch.empty((hops, b), dtype=torch.int32, device=dev)
    if hops == 0 or b == 0:
        return trace
    lib = cuda_build.bind(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.walk_launch(origin_ext.data_ptr(), i2c_ext.data_ptr(),
                              c2i_ext.data_ptr(), origins.data_ptr(),
                              uniforms.data_ptr(), trace.data_ptr(), b, hops,
                              float(alpha), stream)
    cuda_build.check(lib, NAME, err)
    launches += 1
    return trace


def restart_walks(tables: Tables, nodeset: torch.Tensor, n_hops: int,
                  alpha: float, uniforms: torch.Tensor,
                  n_chains: int = 1) -> torch.Tensor:
    """Restart walks -> trace [B, n_hops] int32 (see
    ``ops.walks.walks_from_fused_tables``): K1 on CUDA tensors, the plain
    version on CPU tensors."""
    if uniforms.device.type == "cpu":
        return walks_from_fused_tables(tables, nodeset, n_hops, alpha,
                                       uniforms, n_chains)
    if uniforms.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not "
                         f"{uniforms.device}")
    origins, _ = chain_origins(nodeset, n_hops, n_chains)
    trace = walk_hops_cuda(tables, origins.contiguous(), uniforms, alpha)
    return trace.t().reshape(nodeset.shape[0], n_hops)


def random_walks(tables: Tables, nodeset: torch.Tensor, n_hops: int,
                 alpha: float, generator: torch.Generator,
                 n_chains: int = 1) -> torch.Tensor:
    """``restart_walks`` with the uniforms drawn from ``generator``."""
    origins, hops = chain_origins(nodeset, n_hops, n_chains)
    uniforms = draw_uniforms(hops, origins.shape[0], generator)
    return restart_walks(tables, nodeset, n_hops, alpha, uniforms, n_chains)
