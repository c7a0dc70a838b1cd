"""K2: fused neighbor gather + Q-MLP + importance-weighted mean.

    agg[b] = sum_t w[b,t] * leaky_relu(h[nb[b,t]] @ Wq^T + bq)
             / (sum_t w[b,t], or 1 where that sum is 0)

``conv_aggregate`` is the aggregation inside every PinSage conv layer.
For tensors on the CPU it runs ``conv_aggregate_plain`` (gather + einsum,
the JAX package's default path) under PyTorch's own autograd.  For CUDA
tensors it goes through ``ConvAggregate``, whose forward launches the
kernel that ``mode`` names -- ``"stream"``: K2 (``csrc/agg.cu``), which
never materializes the [B*T, Din] gather; ``"dma"``: K3
(``csrc/dma_agg.cu``, ``ops/dma_agg.py``), the same function with
explicit row copies -- and whose backward carries the gradient to h, Wq
and bq.  A CUDA call either launches its kernel or raises: there is no
fallback, and no CUDA call returns a tensor that gradients do not reach.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gcn_song_embeddings_tpu_torch.ops import cuda_build, dma_agg

NAME = "agg"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/agg.cu"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_agg.py:52"
MAX_T = 64  # all T rows of a node share the kernels' BM = 64-row tile
MODES = {"stream": "K2", "dma": "K3"}

launches = 0  # kernel launches (not plain-version calls) since the last reset
# ConvAggregate.backward calls on CUDA tensors, by forward mode
backward_launches = {"stream": 0, "dma": 0}

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
                        bq: torch.Tensor, mode: str = "stream"
                        ) -> torch.Tensor:
    """Launch K2 (mode "stream") or K3 (mode "dma") on CUDA tensors: h
    [N, Din] f32, nb_nodes [B, T] int32 (ids in [0, N)), nb_weights [B, T]
    f32, Wq [H, Din] f32, bq [H] f32 -> [B, H] f32.  Records no graph, so
    it refuses inputs that need a gradient: ``conv_aggregate`` is the
    differentiable entry."""
    global launches
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    kernel = MODES[mode]
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (h, nb_weights, Wq, bq)):
        raise ValueError(f"{kernel} launched directly records no gradient: "
                         f"call conv_aggregate for inputs that need one")
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
        raise ValueError(f"{kernel} takes 1 <= T <= {MAX_T} and Din, H "
                         f"positive multiples of 4 (16-byte loads), got "
                         f"T={t}, Din={din}, H={hdim}")
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned (16-byte loads)")
    out = torch.empty((b, hdim), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    wq_t = Wq.t().contiguous()  # [Din, H]: coalesced column-tile loads
    if mode == "dma":
        dma_agg.launch(h, nb_nodes, nb_weights, wq_t, bq, out)
        return out
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
    neighborhood cache."""

    @staticmethod
    def forward(ctx, h, nb_nodes, nb_weights, Wq, bq, mode):
        if h.device.type == "cpu":
            out = conv_aggregate_plain(h, nb_nodes, nb_weights, Wq, bq)
        else:
            out = conv_aggregate_cuda(h, nb_nodes, nb_weights, Wq, bq, mode)
        ctx.save_for_backward(h, nb_nodes, nb_weights, Wq, bq)
        ctx.mode = mode
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dagg):
        h, nb_nodes, nb_weights, Wq, bq = ctx.saved_tensors
        need_h, _, _, need_wq, need_bq, _ = ctx.needs_input_grad
        ids = nb_nodes.reshape(-1).long()
        proj = torch.addmm(bq, h, Wq.t())                    # [N, H]
        pre = proj[ids]                                       # [B*T, H]
        w_sum = nb_weights.sum(dim=1, keepdim=True)
        denom = torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)
        dq = ((nb_weights / denom)[:, :, None]
              * dagg[:, None, :]).reshape(pre.shape)
        dpre = torch.where(pre >= 0.0, dq, 0.01 * dq)
        s = torch.zeros_like(proj).index_add_(0, ids, dpre)  # [N, H]
        dh = s @ Wq if need_h else None
        dwq = s.t() @ h if need_wq else None
        dbq = s.sum(dim=0) if need_bq else None
        if dagg.device.type == "cuda":
            backward_launches[ctx.mode] += 1
        return dh, None, None, dwq, dbq, None


def conv_aggregate(h: torch.Tensor, nb_nodes: torch.Tensor,
                   nb_weights: torch.Tensor, Wq: torch.Tensor,
                   bq: torch.Tensor, mode: str = "stream") -> torch.Tensor:
    """Importance-weighted neighbor aggregation [B, H]: on CUDA tensors
    through ``ConvAggregate`` (K2 for mode "stream", K3 for "dma"), on CPU
    tensors the plain version (both modes: they compute one function)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if h.device.type == "cpu":
        return conv_aggregate_plain(h, nb_nodes, nb_weights, Wq, bq)
    if h.device.type != "cuda":
        raise ValueError(f"{MODES[mode]} runs on CUDA or CPU tensors, not "
                         f"{h.device}")
    if nb_weights.requires_grad and torch.is_grad_enabled():
        raise ValueError("nb_weights get no gradient on CUDA (constants of "
                         "the neighborhood cache): pass them detached")
    return ConvAggregate.apply(h, nb_nodes.to(torch.int32).contiguous(),
                               nb_weights.contiguous(), Wq.contiguous(),
                               bq.contiguous(), mode)
