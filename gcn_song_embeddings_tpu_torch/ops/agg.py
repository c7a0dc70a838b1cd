"""K2: fused neighbor gather + Q-MLP + importance-weighted mean.

    agg[b] = sum_t w[b,t] * leaky_relu(h[nb[b,t]] @ Wq^T + bq)
             / (sum_t w[b,t], or 1 where that sum is 0)

``conv_aggregate`` is the aggregation inside every PinSage conv layer.
For tensors on the CPU it runs ``conv_aggregate_plain`` (gather + einsum,
the JAX package's default path); for CUDA tensors it launches the kernel
of ``csrc/agg.cu``, which never materializes the [B*T, Din] gather, or
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gcn_song_embeddings_tpu_torch.ops import cuda_build

NAME = "agg"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/agg.cu"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_agg.py:52"
MAX_T = 64  # all T rows of a node share the kernel's BM = 64-row tile

launches = 0  # kernel launches (not plain-version calls) since the last reset

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def conv_aggregate_plain(h: torch.Tensor, nb_nodes: torch.Tensor,
                         nb_weights: torch.Tensor, Wq: torch.Tensor,
                         bq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: materialized gather, einsum, weighted mean."""
    nb = h[nb_nodes.reshape(-1).long()].reshape(*nb_nodes.shape, h.shape[1])
    q = F.leaky_relu(torch.einsum("btd,hd->bth", nb, Wq) + bq, 0.01)
    w_sum = nb_weights.sum(dim=1, keepdim=True)
    denom = torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)
    return (nb_weights[:, :, None] * q).sum(dim=1) / denom


def conv_aggregate_cuda(h: torch.Tensor, nb_nodes: torch.Tensor,
                        nb_weights: torch.Tensor, Wq: torch.Tensor,
                        bq: torch.Tensor) -> torch.Tensor:
    """Launch K2 on CUDA tensors: h [N, Din] f32, nb_nodes [B, T] int32 (ids
    in [0, N)), nb_weights [B, T] f32, Wq [H, Din] f32, bq [H] f32 ->
    [B, H] f32."""
    global launches
    dev = h.device
    for name, t, dtype, dim in (("h", h, torch.float32, 2),
                                ("nb_nodes", nb_nodes, torch.int32, 2),
                                ("nb_weights", nb_weights, torch.float32, 2),
                                ("Wq", Wq, torch.float32, 2),
                                ("bq", bq, torch.float32, 1)):
        if t.device != dev or t.dtype != dtype or t.dim() != dim:
            raise ValueError(f"{name} must be a {dim}-d {dtype} tensor on "
                             f"{dev}, got {t.dim()}-d {t.dtype} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, t = nb_nodes.shape
    din, hdim = h.shape[1], Wq.shape[0]
    if (nb_weights.shape != nb_nodes.shape or Wq.shape[1] != din
            or bq.shape[0] != hdim):
        raise ValueError(f"shape mismatch: h {list(h.shape)}, nb_nodes "
                         f"{list(nb_nodes.shape)}, nb_weights "
                         f"{list(nb_weights.shape)}, Wq {list(Wq.shape)}, "
                         f"bq {list(bq.shape)}")
    if not 1 <= t <= MAX_T or min(din, hdim) < 1 or din % 4 or hdim % 4:
        raise ValueError(f"K2 takes 1 <= T <= {MAX_T} and Din, H positive "
                         f"multiples of 4 (float4 loads), got T={t}, "
                         f"Din={din}, H={hdim}")
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned (float4 loads)")
    out = torch.empty((b, hdim), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    wq_t = Wq.t().contiguous()  # [Din, H]: coalesced column-tile loads
    lib = cuda_build.bind(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.agg_launch(h.data_ptr(), nb_nodes.data_ptr(),
                             nb_weights.data_ptr(), wq_t.data_ptr(),
                             bq.data_ptr(), out.data_ptr(), b, t, din, hdim,
                             stream)
    cuda_build.check(lib, NAME, err)
    launches += 1
    return out


def conv_aggregate(h: torch.Tensor, nb_nodes: torch.Tensor,
                   nb_weights: torch.Tensor, Wq: torch.Tensor,
                   bq: torch.Tensor) -> torch.Tensor:
    """Importance-weighted neighbor aggregation [B, H]: K2 on CUDA
    tensors, the plain version on CPU tensors."""
    if h.device.type == "cpu":
        return conv_aggregate_plain(h, nb_nodes, nb_weights, Wq, bq)
    if h.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {h.device}")
    return conv_aggregate_cuda(h, nb_nodes.to(torch.int32).contiguous(),
                               nb_weights.contiguous(), Wq.contiguous(),
                               bq.contiguous())
