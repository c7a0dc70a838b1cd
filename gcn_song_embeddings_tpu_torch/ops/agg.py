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

A CUDA call either launches its kernels or raises: there is no fallback,
and no CUDA call returns a tensor that gradients do not reach.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gcn_song_embeddings_tpu_torch.ops import cuda_build, dma_agg

NAME = "agg"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/agg.cu"
HEADER = "gcn_song_embeddings_tpu_torch/csrc/agg_tc.cuh"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_agg.py:52"
MAX_T = 64  # a K3 block (192 rows) holds whole nodes: 3 at T = 64
MODES = {"stream": "K2", "dma": "K3"}
BN, BK, SLAB = 128, 32, 64  # Wq tile rows and floats (agg_tc.cuh); P slab

launches = 0  # K2 op calls on CUDA tensors since the last reset
# launches of each K2 kernel (the split also runs for every K3 call)
kernel_launches = {"split": 0, "project": 0, "gather_mean": 0}
# ConvAggregate.backward calls on CUDA tensors, by forward mode
backward_launches = {"stream": 0, "dma": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"split": [_P] * 3 + [_I] * 2 + [_P],
             "project": [_P] * 5 + [_I] * 3 + [_P],
             "gather": [_P] * 4 + [_I] * 4 + [_P]}


def _denominator(nb_weights: torch.Tensor) -> torch.Tensor:
    """[B, 1]: each node's weight sum, or 1 where that sum is 0."""
    w_sum = nb_weights.sum(dim=1, keepdim=True)
    return torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)


def conv_aggregate_plain(h: torch.Tensor, nb_nodes: torch.Tensor,
                         nb_weights: torch.Tensor, Wq: torch.Tensor,
                         bq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: materialized gather, einsum, weighted mean."""
    nb = h[nb_nodes.reshape(-1).long()].reshape(*nb_nodes.shape, h.shape[1])
    q = F.leaky_relu(torch.einsum("btd,hd->bth", nb, Wq) + bq, 0.01)
    return (nb_weights[:, :, None] * q).sum(dim=1) / _denominator(nb_weights)


def project_table_plain(h: torch.Tensor, Wq: torch.Tensor,
                        bq: torch.Tensor) -> torch.Tensor:
    """K2's first phase, plain: every table row projected once, [N, H]."""
    return F.leaky_relu(torch.addmm(bq, h, Wq.t()), 0.01)


def gather_mean_plain(proj: torch.Tensor, nb_nodes: torch.Tensor,
                      nb_weights: torch.Tensor) -> torch.Tensor:
    """K2's second phase, plain: the weighted mean of rows of ``proj``."""
    rows = proj[nb_nodes.reshape(-1).long()].reshape(*nb_nodes.shape, -1)
    return ((nb_weights[:, :, None] * rows).sum(dim=1)
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


def tile_wq_plain(x: torch.Tensor) -> torch.Tensor:
    """[H, Din] -> the kernels' tile layout [ceil(H/128), ceil(Din/32),
    128, 32]: tile (i, j) holds rows 128i.., columns 32j.., zero-padded,
    with the 16-byte chunk c of row r stored at chunk c ^ (r % 8) (the
    128-byte swizzle the tensor cores read)."""
    hdim, din = x.shape
    nt, kt = -(-hdim // BN), -(-din // BK)
    pad = x.new_zeros((nt * BN, kt * BK))
    pad[:hdim, :din] = x
    tiles = pad.reshape(nt, BN, kt, BK // 4, 4).permute(0, 2, 1, 3, 4)
    r = torch.arange(BN, device=x.device)
    chunk = torch.arange(BK // 4, device=x.device)[None, :] ^ (r % 8)[:, None]
    return tiles[:, :, r[:, None], chunk].reshape(nt, kt, BN, BK)


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
                  t: int | None = None) -> None:
    if t is not None and not 1 <= t <= MAX_T:
        raise ValueError(f"{kernel} takes 1 <= T <= {MAX_T}, got T={t}")
    widths = (hdim,) if din is None else (din, hdim)
    if min(widths) < 1 or any(x % 4 for x in widths):
        raise ValueError(f"{kernel} takes Din and H positive multiples of 4 "
                         f"(16-byte loads), got Din={din}, H={hdim}")


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


def _tiles_shape(hdim: int, din: int) -> tuple[int, int, int, int]:
    return -(-hdim // BN), -(-din // BK), BN, BK


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


def _gather_mean(proj: torch.Tensor, nb_nodes: torch.Tensor,
                 nb_weights: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    b, t = nb_nodes.shape
    with torch.cuda.device(out.device):
        _launch("gather", proj.data_ptr(), nb_nodes.data_ptr(),
                nb_weights.data_ptr(), out.data_ptr(), b, t, proj.shape[1],
                out.shape[1])
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
    int32 names (ids in [0, N))."""
    kernel = "K2's gather-mean"
    _refuse_grad(kernel, proj, nb_weights, out)
    _check_tensors((("proj", proj, torch.float32, 3),
                    ("nb_nodes", nb_nodes, torch.int32, 2),
                    ("nb_weights", nb_weights, torch.float32, 2),
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
    _refuse_grad(kernel, h, nb_weights, Wq, bq)
    _check_tensors((("h", h, torch.float32, 2),
                    ("nb_nodes", nb_nodes, torch.int32, 2),
                    ("nb_weights", nb_weights, torch.float32, 2),
                    ("Wq", Wq, torch.float32, 2),
                    ("bq", bq, torch.float32, 1)))
    b, t = nb_nodes.shape
    din, hdim = h.shape[1], Wq.shape[0]
    if (nb_weights.shape != nb_nodes.shape or Wq.shape[1] != din
            or bq.shape[0] != hdim):
        raise _mismatch(h=h, nb_nodes=nb_nodes, nb_weights=nb_weights, Wq=Wq,
                        bq=bq)
    _check_widths(kernel, hdim, din, t)
    _check_aligned(h=h)
    _check_cuda(kernel, h.device)
    out = torch.empty((b, hdim), dtype=torch.float32, device=h.device)
    if b == 0:
        return out
    if h.shape[0] == 0:
        raise ValueError("h has no rows for nb_nodes to name")
    big, small = _split_wq(Wq)
    if mode == "dma":
        dma_agg.launch(h, nb_nodes, nb_weights, big, small, bq, out)
        return out
    _gather_mean(_project_table(h, big, small, bq), nb_nodes, nb_weights, out)
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
        dq = ((nb_weights / _denominator(nb_weights))[:, :, None]
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
