"""Calls that K2's kernel entries (``ops.agg.split_wq``, ``project_table``
and ``gather_mean``) and ``conv_aggregate_cuda`` must refuse with a
ValueError before they launch anything, shared by the CPU
tests (tests/test_torch_agg.py) and the GPU tests
(tests/test_torch_kernels_gpu.py).

Each case is (id, call, match): ``call(t)`` makes the call from the
well-formed tensors ``tensors(device)`` with one thing wrong.  The device
cases move the first tensor to the CPU: on the CPU every tensor is
there, which the entries refuse as they launch only on CUDA tensors.
"""

from types import SimpleNamespace

import torch

from gcn_song_embeddings_tpu_torch.ops import agg

N, DIN, H, B, T = 20, 8, 8, 5, 3


def tensors(device) -> SimpleNamespace:
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((N, DIN), generator=gen)
    Wq = torch.randn((H, DIN), generator=gen) * 0.1
    big, small = (agg.tile_wq_plain(x) for x in agg.tf32_split(Wq))
    t = SimpleNamespace(
        h=h, Wq=Wq, big=big, small=small, bq=torch.zeros(H),
        nb=torch.randint(0, N, (B, T), generator=gen, dtype=torch.int32),
        w=torch.rand((B, T), generator=gen),
        proj=torch.zeros((-(-H // agg.SLAB), N, agg.SLAB)),
        out=torch.zeros((B, H)))
    for k, v in vars(t).items():
        setattr(t, k, v.to(device))
    return t


CASES = [
    ("split-float64", lambda t: agg.split_wq(t.Wq.double()), "float32"),
    ("split-strided", lambda t: agg.split_wq(t.Wq.t()), "contiguous"),
    ("split-width", lambda t: agg.split_wq(t.Wq[:6].contiguous()),
     "multiples of 4"),
    ("split-grad", lambda t: agg.split_wq(t.Wq.clone().requires_grad_()),
     "gradient"),
    ("split-device", lambda t: agg.split_wq(t.Wq.cpu()), "CUDA tensors"),
    ("project-int-h", lambda t: agg.project_table(
        t.h.int(), t.big, t.small, t.bq), "float32"),
    ("project-strided-h", lambda t: agg.project_table(
        t.h[:, :4], t.big, t.small, t.bq), "contiguous"),
    ("project-tiles-of-another-din", lambda t: agg.project_table(
        t.h.new_zeros((N, 40)), t.big, t.small, t.bq),
     "shape mismatch"),
    ("project-no-rows", lambda t: agg.project_table(
        t.h[:0], t.big, t.small, t.bq), "no rows"),
    ("project-grad", lambda t: agg.project_table(
        t.h.clone().requires_grad_(), t.big, t.small, t.bq), "gradient"),
    ("project-device", lambda t: agg.project_table(
        t.h.cpu(), t.big, t.small, t.bq), "CUDA tensors|on cpu"),
    ("gather-int64-ids", lambda t: agg.gather_mean(
        t.proj, t.nb.long(), t.w, t.out), "int32"),
    ("gather-weights-shape", lambda t: agg.gather_mean(
        t.proj, t.nb, t.w[:, :2].contiguous(), t.out), "shape mismatch"),
    ("gather-out-width", lambda t: agg.gather_mean(
        t.proj, t.nb, t.w, t.out.new_zeros((B, 68))),
     "shape mismatch"),
    ("gather-T", lambda t: agg.gather_mean(
        t.proj, t.nb.new_zeros((B, 0)),
        t.w.new_ones((B, 0)), t.out), "T >= 1"),
    ("gather-strided-out", lambda t: agg.gather_mean(
        t.proj, t.nb, t.w, t.out.new_zeros((H, B)).t()),
     "contiguous"),
    ("gather-grad", lambda t: agg.gather_mean(
        t.proj.clone().requires_grad_(), t.nb, t.w, t.out), "gradient"),
    ("gather-device", lambda t: agg.gather_mean(
        t.proj.cpu(), t.nb, t.w, t.out), "CUDA tensors|on cpu"),
    ("aggregate-device", lambda t: agg.conv_aggregate_cuda(
        t.h.cpu(), t.nb, t.w, t.Wq, t.bq), "CUDA tensors|on cpu"),
]
