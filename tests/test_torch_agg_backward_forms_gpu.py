"""The aggregation's backward in its two forms on the card
(``csrc/agg_bwd.cu``): the frontier kernel (``agg.agg_bwd_frontier``,
where entry e is table row e) and the table form's kernels over runs of
every length (``agg.agg_bwd_rows``: runs of at most 128 summed by a warp
a row, longer ones in chunks of 128 on warps of their own), each held
against its plain twin bit for bit, on uniform ids, on hub ids and on the
frontier's identity; and ``ConvAggregate`` told the identity (ids None)
against the same backward over the ``arange`` ids.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_agg_backward_forms_gpu.py
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.ops import agg

pytestmark = pytest.mark.gpu

PASSES = {"p0": None, "p1": 1, "p3": 3}
WEIGHTS = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16}
# a row named this many times, about the warp's 128 and far past it
LONG_RUNS = [127, 128, 129, 255, 256, 257, 1000, 2048, 20000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _residual(dev, kind, n_rows, n_entries, hdim, gen):
    """A random slope residual: K2's projected table [ceil(H/64), N, 64]
    ("rows") or K3's bits [E, slope_words(H)] ("bits")."""
    if kind == "rows":
        return torch.randn((-(-hdim // agg.SLAB), n_rows, agg.SLAB),
                           device=dev, generator=gen)
    return torch.randint(-2 ** 31, 2 ** 31 - 1,
                         (n_entries, agg.slope_words(hdim)), device=dev,
                         dtype=torch.int64, generator=gen).to(torch.int32)


def _hold(parts, dbq, want, want_dbq, full):
    assert len(parts) == len(want)
    for got, ref in zip(parts, want):
        assert torch.equal(got, ref)
    scale = full.abs().sum(dim=0)
    assert bool(((dbq - want_dbq).abs() <= 1e-6 * scale + 1e-30).all())


@pytest.mark.parametrize("hdim", [200, 512])
@pytest.mark.parametrize("residual", ["rows", "bits"])
@pytest.mark.parametrize("passes", list(PASSES))
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_frontier_kernel_is_its_twin_bit_for_bit(cuda, weights, passes,
                                                 residual, hdim):
    """S (its parts) of the frontier kernel equal to its twin's and to
    the table twin's over the CSR of the ``arange`` bit for bit; dbq
    within 1e-6 of the column sums of |S|; one launch counted, no CSR."""
    b, t = 601, 10
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.rand((b, t), device=cuda, generator=gen)
    w[3] = 0.0
    w = w.to(WEIGHTS[weights])
    dagg = torch.randn((b, hdim), device=cuda, generator=gen)
    res = _residual(cuda, residual, b * t, b * t, hdim, gen)
    p = PASSES[passes]
    before = (agg.bwd_frontier_launches, agg.bwd_launches, agg.csr_launches)
    parts, dbq = agg.agg_bwd_frontier(w, dagg, res, p)
    torch.cuda.synchronize()
    assert (agg.bwd_frontier_launches, agg.bwd_launches,
            agg.csr_launches) == (before[0] + 1, *before[1:])
    want, want_dbq = agg.agg_bwd_frontier_plain(w, dagg, res, p)
    full = agg.agg_bwd_frontier_plain(w, dagg, res)[0][0]
    _hold(parts, dbq, want, want_dbq, full)
    ids = agg.identity_ids(dagg.new_empty((b * t, 1)), w)
    table, _ = agg.agg_bwd_rows_plain(*agg.backward_csr_plain(ids, b * t), w,
                                      dagg, res, p)
    assert all(torch.equal(g, r) for g, r in zip(parts, table))


def _run_ids(dev, runs, n, b, t, seed):
    rng = np.random.default_rng(seed)
    flat = rng.integers(len(runs), n, b * t)
    places = rng.permutation(b * t)
    at = 0
    for row, k in enumerate(runs):
        flat[places[at:at + k]] = row
        at += k
    return torch.as_tensor(flat.reshape(b, t).astype(np.int32), device=dev)


@pytest.mark.parametrize("hdim", [100, 200, 512, 1024])
@pytest.mark.parametrize("residual", ["rows", "bits"])
@pytest.mark.parametrize("passes", list(PASSES))
def test_table_kernels_are_the_chunked_twin_on_long_runs(cuda, passes,
                                                         residual, hdim):
    """Rows named 127 .. 20,000 times among uniform ids: the table form's
    kernels (each long run's chunks of 128 on warps of their own, then a
    warp a row) equal the chunked twin bit for bit at widths of one, two,
    four and eight 128-column chunks."""
    b, t, n = 4000, 10, 9000
    ids = _run_ids(cuda, LONG_RUNS, n, b, t, seed=hdim)
    gen = torch.Generator(device=cuda).manual_seed(2)
    w = torch.rand((b, t), device=cuda, generator=gen)
    w[5] = 0.0
    dagg = torch.randn((b, hdim), device=cuda, generator=gen)
    res = _residual(cuda, residual, n, b * t, hdim, gen)
    p = PASSES[passes]
    offsets, entries = agg.backward_csr(ids, n)
    before = agg.bwd_launches
    parts, dbq = agg.agg_bwd_rows(offsets, entries, w, dagg, res, p)
    torch.cuda.synchronize()
    assert agg.bwd_launches == before + 1
    want, want_dbq = agg.agg_bwd_rows_plain(offsets, entries, w, dagg, res,
                                            p)
    full = agg.agg_bwd_rows_plain(offsets, entries, w, dagg, res)[0][0]
    _hold(parts, dbq, want, want_dbq, full)


@pytest.mark.parametrize("kind", ["uniform", "hubs"])
def test_table_kernels_at_the_full_graphs_size(cuda, kind):
    """The full graph's 100k x 10 ids, uniform or with rows named
    100,000, 10,000, 3,000 and 300 times, H 512, K2's residual: the
    kernels equal the chunked twin bit for bit, and two runs give the
    same bits."""
    n, t, hdim = 100_000, 10, 512
    ids = (_run_ids(cuda, [100_000, 10_000, 3000, 300], n, n, t, seed=5)
           if kind == "hubs" else _run_ids(cuda, [], n, n, t, seed=6))
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.rand((n, t), device=cuda, generator=gen)
    dagg = torch.randn((n, hdim), device=cuda, generator=gen)
    res = _residual(cuda, "rows", n, n * t, hdim, gen)
    csr = agg.backward_csr(ids, n)
    parts, dbq = agg.agg_bwd_rows(*csr, w, dagg, res)
    again, dbq2 = agg.agg_bwd_rows(*csr, w, dagg, res)
    want, want_dbq = agg.agg_bwd_rows_plain(*csr, w, dagg, res)
    _hold(parts, dbq, want, want_dbq, want[0])
    assert torch.equal(again[0], parts[0]) and torch.equal(dbq2, dbq)


@pytest.mark.parametrize("passes", list(PASSES))
@pytest.mark.parametrize("mode", ["stream", "dma"])
def test_identity_backward_is_the_arange_backward(cuda, mode, passes):
    """``ConvAggregate`` with ids None (entry e is row e) launches the
    frontier kernel and no CSR; its dh and dWq equal those of the same
    call over the ``arange`` ids (the table form) bit for bit, dbq within
    1e-6 of the column sums of |S|, and two runs give the same bits."""
    b, t, din, hdim = 300, 10, 64, 200
    gen = torch.Generator(device=cuda).manual_seed(4)
    h = torch.randn((b * t, din), device=cuda, generator=gen)
    w = torch.rand((b, t), device=cuda, generator=gen)
    Wq = torch.randn((hdim, din), device=cuda, generator=gen) * 0.1
    bq = torch.full((hdim,), 0.1, device=cuda)
    cot = torch.randn((b, hdim), device=cuda, generator=gen)
    p = PASSES[passes]

    def grads(ids):
        leaves = [x.detach().clone().requires_grad_() for x in (h, Wq, bq)]
        out = agg.ConvAggregate.apply(leaves[0], ids, w, leaves[1],
                                      leaves[2], mode, None, p, True)
        return torch.autograd.grad(out, leaves, cot)

    before = (agg.bwd_frontier_launches, agg.bwd_launches, agg.csr_launches)
    first, second = grads(None), grads(None)
    torch.cuda.synchronize()
    assert (agg.bwd_frontier_launches, agg.bwd_launches,
            agg.csr_launches) == (before[0] + 2, *before[1:])
    ids = agg.identity_ids(h, w)
    table = grads(ids)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    assert torch.equal(first[0], table[0])
    assert torch.equal(first[1], table[1])
    _, res = agg.conv_aggregate_cuda(h, ids, w, Wq, bq, mode, None, p,
                                     residual=True)
    (s,), _ = agg.agg_bwd_frontier_plain(w, cot, res)
    assert bool(((first[2] - table[2]).abs()
                 <= 1e-6 * s.abs().sum(dim=0) + 1e-30).all())
