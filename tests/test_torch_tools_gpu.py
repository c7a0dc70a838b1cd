"""K3 and its backward at the shapes of the repository tools' frontier
steps, against their plain PyTorch versions on the card.

* ``fullgraph_bench``'s B=4,096 frontier step (N=20,000, Din 512, T=3,
  two layers, hidden 512): the deepest aggregation, 49,152 nodes over
  196,608 gathered feature rows, and the top one, 12,288 nodes over the
  deepest one's 128-d output;
* ``grid_refschedule``'s ``ref`` schedule at four layers (B=128, T=3,
  Din 512, hidden 512): the deepest aggregation, 24,576 nodes over
  98,304 gathered rows, and the one above it, 6,144 nodes over 128-d
  rows.

Ids index the table as the frontier forward does (node ``i``'s T
neighbours are rows ``m + i * T ..``).  The forward within 1e-4 of the
plain version, the backward (dh where the table is an activation, dWq,
dbq) within 1e-3 relative of float64 autograd through the plain version,
as tests/test_torch_kernels_gpu.py holds the train step's shapes.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tools_gpu.py
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg

pytestmark = pytest.mark.gpu

AGG_ATOL = 1e-4
GRAD_RTOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _frontier_args(device, m, t, din, h, seed):
    """A table of m * (t + 1) rows, node i's neighbours at rows m + i*t..,
    seeded weights (node 3's all zero), Wq and bq."""
    rng = np.random.default_rng(seed)
    n = m * (t + 1)
    ids = (m + np.arange(m * t, dtype=np.int32)).reshape(m, t)
    w = rng.random((m, t)).astype(np.float32)
    w[3] = 0.0
    return [torch.as_tensor(a, device=device) for a in (
        rng.normal(size=(n, din)).astype(np.float32), ids, w,
        (rng.normal(size=(h, din)) * 0.05).astype(np.float32),
        np.full(h, 0.3, np.float32))]


SHAPES = [  # (m, T, Din, H, need_dh)
    pytest.param(49152, 3, 512, 512, False, id="fullgraph_bench_B4096_deep"),
    pytest.param(12288, 3, 128, 512, True, id="fullgraph_bench_B4096_top"),
    pytest.param(24576, 3, 512, 512, False, id="ref_L4_deep"),
    pytest.param(6144, 3, 128, 512, True, id="ref_L4_second")]


@pytest.mark.parametrize("m,t,din,h,need_dh", SHAPES)
def test_k3_and_backward_at_the_tools_frontier_shapes(cuda, m, t, din, h,
                                                      need_dh):
    args = _frontier_args(cuda, m, t, din, h, seed=m)
    before = dma_agg.launches
    with torch.inference_mode():
        got = agg.conv_aggregate(*args, mode="dma")
        want = agg.conv_aggregate_plain(*args)
    torch.cuda.synchronize()
    assert dma_agg.launches == before + 1
    assert float((got - want).abs().max()) <= AGG_ATOL
    assert torch.equal(got[3], torch.zeros_like(got[3]))

    cot = torch.randn((m, h), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(1))

    def grads(dtype, fn):
        tab, nb, w, Wq, bq = (a if a.dtype == torch.int32
                              else a.to(dtype, copy=True) for a in args)
        inputs = ((tab, Wq, bq) if need_dh else (Wq, bq))
        for x in inputs:
            x.requires_grad_()
        out = fn(tab, nb, w, Wq, bq)
        return torch.autograd.grad(out, inputs, cot.to(dtype))

    ref = grads(torch.float64, agg.conv_aggregate_plain)
    before = agg.backward_launches["dma"]
    got = grads(torch.float32, lambda *a: agg.conv_aggregate(*a, mode="dma"))
    torch.cuda.synchronize()
    assert agg.backward_launches["dma"] == before + 1
    for g, r in zip(got, ref):
        err = torch.linalg.vector_norm(g.double() - r) / \
            torch.linalg.vector_norm(r)
        assert float(err) <= GRAD_RTOL
