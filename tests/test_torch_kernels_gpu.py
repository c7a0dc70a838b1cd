"""CUDA kernels K1, K2, K3 and K4 against their plain PyTorch versions,
the aggregation's backward against plain autograd, and the int8 scores on
the GPU against the CPU's.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX, so they
run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.ops import (
    agg,
    dma_agg,
    quant_kernel,
    walk_kernel,
)
from gcn_song_embeddings_tpu_torch.ops.quantize import (
    int8_scores,
    pad_table,
    quantize_rows,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    draw_uniforms,
    fused_walk_tables,
    walks_from_fused_tables,
)
import torch_agg_entry_cases as entry_cases

pytestmark = pytest.mark.gpu

AGG_ATOL = 1e-4  # f32, another summation order than the einsum path
GRAD_RTOL = 1e-3  # chip_smoke.py's bar for the aggregation's backward


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _graph(device, n_items=300, n_cols=60, deg=4, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_cols, (n_items, deg))
    i2c_indptr = np.arange(n_items + 1, dtype=np.int32) * deg
    src = np.repeat(np.arange(n_items, dtype=np.int32), deg)
    flat = cols.reshape(-1)
    order = np.lexsort((src, flat))
    c2i_indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=n_cols), out=c2i_indptr[1:])
    return DeviceGraph.from_arrays(i2c_indptr, flat, c2i_indptr, src[order],
                                   device)


@pytest.mark.parametrize("alpha,b,hops,chains,ties", [
    (0.85, 7, 40, 1, False), (0.0, 7, 25, 1, False),
    (0.85, 4096, 500, 1, False), (0.85, 33, 60, 2, False),
    (1.0, 7, 40, 1, False), (0.5, 33, 60, 1, False),
    (0.15, 33, 200, 1, False),               # long restart segments
    (0.85, 1, 1000, 1, False), (0.85, 4, 1000, 1, False),  # live-walk
    (0.0, 4096, 500, 1, False), (0.85, 33, 60, 4, False),
    (0.85, 64, 100, 1, True), (0.5, 64, 100, 1, True)])
def test_walk_kernel_bit_identical(cuda, alpha, b, hops, chains, ties):
    tables = fused_walk_tables(_graph(cuda))
    nodeset = torch.randint(0, 300, (b,), dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b)
    uniforms = draw_uniforms(hops // chains, b * chains, gen)
    if ties:   # the restart compare's boundary: u2 == f32(alpha) exactly
        uniforms[::3, ::2, 2] = torch.tensor(alpha, dtype=torch.float32)
    before = walk_kernel.launches
    got = walk_kernel.restart_walks(tables, nodeset, hops, alpha, uniforms,
                                    chains)
    want = walks_from_fused_tables(tables, nodeset, hops, alpha, uniforms,
                                   chains)
    torch.cuda.synchronize()
    assert walk_kernel.launches == before + 1
    assert got.shape == (b, hops) and got.dtype == torch.int32
    assert torch.equal(got, want)


def _agg_args(device, b, t, n, din, h, seed=None):
    rng = np.random.default_rng(b if seed is None else seed)
    args = [torch.as_tensor(a, device=device) for a in (
        rng.normal(size=(n, din)).astype(np.float32),
        rng.integers(0, n, (b, t)).astype(np.int32),
        rng.random((b, t)).astype(np.float32),
        (rng.normal(size=(h, din)) * 0.05).astype(np.float32),
        np.full(h, 0.3, np.float32))]
    if b > 3:
        args[2][3] = 0.0                  # all-zero neighborhood guard
    return args


@pytest.mark.parametrize("b,t,n,din,h", [
    (300, 3, 1000, 256, 128), (65, 3, 1000, 256, 128),
    (1000, 10, 5000, 512, 512), (777, 10, 5000, 128, 512),
    (50, 7, 200, 36, 100)])
def test_agg_kernel_matches_plain(cuda, b, t, n, din, h):
    args = _agg_args(cuda, b, t, n, din, h)
    before = agg.launches
    got = agg.conv_aggregate(*args)
    want = agg.conv_aggregate_plain(*args)
    torch.cuda.synchronize()
    assert agg.launches == before + 1
    assert got.shape == (b, h)
    assert float((got - want).abs().max()) <= AGG_ATOL


@pytest.mark.parametrize("b,t,n,din,h", [
    (600, 3, 1000, 256, 128), (130, 3, 1000, 256, 128),
    (50, 10, 200, 36, 100), (4224, 10, 46464, 512, 512),
    (384, 10, 4224, 128, 512), (1, 64, 70, 4, 4)])
def test_dma_agg_kernel_matches_plain(cuda, b, t, n, din, h):
    """K3 at tests/test_pallas_agg.py's shapes (b=600: three TPU tiles;
    b=130 with a zero-weight row), an odd width (Din 36, H 100, T=10:
    one partial Din chunk and column tile) and the train step's two
    frontier shapes."""
    args = _agg_args(cuda, b, t, n, din, h)
    before = (agg.launches, dma_agg.launches)
    got = agg.conv_aggregate(*args, mode="dma")
    want = agg.conv_aggregate_plain(*args)
    torch.cuda.synchronize()
    assert (agg.launches, dma_agg.launches) == (before[0], before[1] + 1)
    assert got.shape == (b, h)
    assert float((got - want).abs().max()) <= AGG_ATOL
    if b > 3:
        assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("mode", ["stream", "dma"])
@pytest.mark.parametrize("b,t,n,din,h", [
    (1, 10, 50, 64, 128), (12, 10, 200, 64, 128), (13, 10, 200, 64, 128),
    (19, 10, 200, 64, 128), (20, 10, 191, 64, 128), (192, 1, 192, 64, 128),
    (193, 1, 193, 64, 128), (300, 1, 400, 64, 128), (64, 3, 400, 64, 128),
    (65, 3, 400, 64, 128), (5, 64, 400, 64, 128), (50, 10, 200, 36, 100),
    (9, 3, 20, 4, 4)])
def test_agg_tile_edges_match_plain(cuda, mode, b, t, n, din, h):
    """Both tensor-core kernels at the edges of their tiles: a K3 node
    tile holds floor(192 / T) nodes (19 at T = 10, so B = 19 and 20 end
    on and past one; 192 and 193 at T = 1, 64 and 65 at T = 3, 3 at T =
    64), K2's projection 192 table rows (N = 191, 192, 193); Din 36 and 4
    end inside a 32-float k chunk, H 100 and 4 inside a 128-column tile.
    A zero-weight row where B > 3."""
    args = _agg_args(cuda, b, t, n, din, h)
    got = agg.conv_aggregate(*args, mode=mode)
    want = agg.conv_aggregate_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (b, h)
    assert float((got - want).abs().max()) <= AGG_ATOL
    if b > 3:
        assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("b,t,n", [(400, 10, 300), (40, 10, 5000)])
def test_k2_table_smaller_and_larger_than_its_gathers(cuda, b, t, n):
    """K2 projects all N table rows, then gathers B*T of them: N < B*T
    (rows reused across nodes) and N > B*T (rows never gathered), each
    phase against its plain version and the whole against the plain
    aggregation."""
    h, nb, w, Wq, bq = _agg_args(cuda, b, t, n, 128, 256)
    before = dict(agg.kernel_launches), agg.launches
    got = agg.conv_aggregate(h, nb, w, Wq, bq)
    big, small = agg.split_wq(Wq)
    proj = agg.project_table(h, big, small, bq)
    rows = agg.slabs_to_rows(proj, 256)
    mean = agg.gather_mean(proj, nb, w, torch.empty_like(got))
    torch.cuda.synchronize()
    assert agg.launches == before[1] + 1
    assert {k: agg.kernel_launches[k] - before[0][k]
            for k in before[0]} == {"split": 2, "project": 2,
                                    "gather_mean": 2}
    assert proj.shape == (4, n, 64)
    want_rows = agg.project_table_plain(h, Wq, bq)
    assert float((rows - want_rows).abs().max()) <= AGG_ATOL
    assert float((mean - agg.gather_mean_plain(rows, nb, w)).abs().max()) \
        <= 1e-6
    assert torch.equal(got, mean)
    assert float((got - agg.conv_aggregate_plain(h, nb, w, Wq, bq))
                 .abs().max()) <= AGG_ATOL


@pytest.mark.parametrize("hdim,din", [(512, 512), (100, 36), (4, 4)])
def test_wq_split_kernel_bit_identical(cuda, hdim, din):
    """The Wq split kernel equals the tiled plain split bit for bit."""
    Wq = torch.as_tensor(np.random.default_rng(hdim).normal(
        size=(hdim, din)).astype(np.float32) * 0.05, device=cuda)
    big, small = agg.split_wq(Wq)
    want = [agg.tile_wq_plain(x) for x in agg.tf32_split(Wq)]
    torch.cuda.synchronize()
    assert torch.equal(big.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(small.view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("mode", ["stream", "dma"])
def test_agg_error_vs_float64_is_f32_class(cuda, mode):
    """At Din = H = 512 the kernel's max error against float64 is at most
    4x the plain f32 version's: three TF32 passes keep f32 accuracy (one
    pass errs ~1e-3, hundreds of times more)."""
    args = _agg_args(cuda, 1200, 10, 6000, 512, 512, seed=11)
    ref = agg.conv_aggregate_plain(*(a if a.dtype == torch.int32
                                     else a.double() for a in args))
    got = agg.conv_aggregate(*args, mode=mode)
    plain = agg.conv_aggregate_plain(*args)
    torch.cuda.synchronize()
    err = float((got.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    assert err <= 4 * plain_err, (err, plain_err)


@pytest.mark.parametrize("mode", ["stream", "dma"])
def test_agg_backward_matches_plain_autograd(cuda, mode):
    """dh, dWq, dbq through ConvAggregate vs autograd through the plain
    version in float64, same inputs and cotangent: relative Frobenius
    error within GRAD_RTOL (f32; an entry of pre within rounding of 0
    may take the other leaky_relu slope, as chip_smoke.py explains)."""
    args = _agg_args(cuda, 700, 10, 3000, 128, 512, seed=3)
    cot = torch.randn((700, 512), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(1))

    def grads(dtype, fn):
        h, nb, w, Wq, bq = (a if a.dtype == torch.int32
                            else a.to(dtype, copy=True) for a in args)
        h, Wq, bq = (x.requires_grad_() for x in (h, Wq, bq))
        out = fn(h, nb, w, Wq, bq)
        return out, torch.autograd.grad(out, (h, Wq, bq), cot.to(dtype))

    _, ref = grads(torch.float64, agg.conv_aggregate_plain)
    before = agg.backward_launches[mode]
    out, got = grads(torch.float32, lambda *a: agg.conv_aggregate(
        *a, mode=mode))
    torch.cuda.synchronize()
    assert out.grad_fn is not None
    assert agg.backward_launches[mode] == before + 1
    for g, r in zip(got, ref):
        err = torch.linalg.vector_norm(g.double() - r) / \
            torch.linalg.vector_norm(r)
        assert float(err) <= GRAD_RTOL


def test_cuda_aggregate_carries_wq_gradient(cuda):
    """A CUDA conv_aggregate with a Wq that requires grad returns a tensor
    with a grad_fn, and Wq.grad equals the plain version's (the kernels
    are launched through ctypes: without the autograd Function the result
    was cut off from Wq and bq)."""
    h, nb, w, Wq, bq = _agg_args(cuda, 90, 3, 400, 64, 64, seed=4)
    Wq.requires_grad_()
    for mode in ("stream", "dma"):
        Wq.grad = None
        out = agg.conv_aggregate(h, nb, w, Wq, bq, mode=mode)
        assert out.grad_fn is not None
        out.square().sum().backward()
        got = Wq.grad.clone()
        Wq.grad = None
        agg.conv_aggregate_plain(h, nb, w, Wq, bq).square().sum().backward()
        assert torch.allclose(got, Wq.grad, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="gradient"):
        agg.conv_aggregate_cuda(h, nb, w, Wq, bq)


def test_kernels_reject_what_they_do_not_take(cuda):
    h = torch.zeros((10, 8), device=cuda)
    ids = torch.zeros((4, 65), dtype=torch.int32, device=cuda)
    w = torch.ones((4, 65), device=cuda)
    with pytest.raises(ValueError, match="T <="):
        agg.conv_aggregate(h, ids, w, torch.zeros((6, 8), device=cuda),
                           torch.zeros(6, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        agg.conv_aggregate(h.double(), ids[:, :3], w[:, :3],
                           torch.zeros((6, 8), device=cuda).double(),
                           torch.zeros(6, device=cuda).double())
    for mode in ("stream", "dma"):        # 16-byte loads and copies
        for din, hdim in ((37, 8), (8, 6)):
            with pytest.raises(ValueError, match="multiples of 4"):
                agg.conv_aggregate(torch.zeros((10, din), device=cuda),
                                   ids[:, :3], w[:, :3],
                                   torch.zeros((hdim, din), device=cuda),
                                   torch.zeros(hdim, device=cuda), mode=mode)
    with pytest.raises(ValueError, match="T <="):
        agg.conv_aggregate(h, ids, w, torch.zeros((8, 8), device=cuda),
                           torch.zeros(8, device=cuda), mode="dma")
    tables = fused_walk_tables(_graph(cuda))
    with pytest.raises(ValueError, match="uniforms"):
        walk_kernel.restart_walks(tables, ids[0, :4], 5, 0.5,
                                  torch.zeros((5, 3, 3), device=cuda))
    origin_ext, i2c_ext, c2i_ext = tables   # int2 records: 8-byte aligned
    odd = torch.empty(i2c_ext.numel() + 1, dtype=torch.int32,
                      device=cuda)[1:].view(-1, 2)
    odd.copy_(i2c_ext)
    with pytest.raises(ValueError, match="aligned"):
        walk_kernel.restart_walks((origin_ext, odd, c2i_ext), ids[0, :4], 5,
                                  0.5, torch.zeros((5, 4, 3), device=cuda))


@pytest.mark.parametrize("call,match", [c[1:] for c in entry_cases.CASES],
                         ids=[c[0] for c in entry_cases.CASES])
def test_kernel_entries_refuse_what_they_cannot_take(cuda, call, match):
    """K2's kernel entries launched one by one refuse CUDA inputs they
    cannot take (wrong dtype, strides, shapes, devices, or a tensor that
    needs a gradient) instead of launching on them."""
    t = entry_cases.tensors(cuda)
    before = dict(agg.kernel_launches)
    with pytest.raises(ValueError, match=match):
        call(t)
    assert agg.kernel_launches == before
    big, small = agg.split_wq(t.Wq)        # the well-formed calls launch
    proj = agg.project_table(t.h, big, small, t.bq)
    agg.gather_mean(proj, t.nb, t.w, t.out)
    torch.cuda.synchronize()
    assert torch.equal(big, t.big) and torch.equal(small, t.small)
    assert float((t.out - agg.conv_aggregate_plain(t.h, t.nb, t.w, t.Wq,
                                                   t.bq)).abs().max()) \
        <= AGG_ATOL


def _unit(n, d, seed):
    e = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d", [(300, 64), (100_000, 128), (1001, 128)])
def test_quant_kernel_bit_identical(cuda, n, d):
    """K4 equals its plain version bit for bit (the random bits are a hash
    of seed, row and column in both), at tests/test_quantize.py's shape,
    the served table's and a ragged row count, with a zero row."""
    emb = torch.as_tensor(_unit(n, d, n), device=cuda)
    emb[1] = 0.0
    before = quant_kernel.launches
    got = quant_kernel.quantize_rows_stochastic(emb, seed=3)
    want = quant_kernel.quantize_rows_stochastic_plain(emb, seed=3)
    torch.cuda.synchronize()
    assert quant_kernel.launches == before + 1
    assert got[0].dtype == torch.int8 and got[0].shape == (n, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1][1]) == 1.0 and not got[0][1].any()
    assert torch.equal(got[1], quantize_rows(emb)[1])


def test_quant_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="multiple of 4"):
        quant_kernel.quantize_rows_stochastic(
            torch.zeros((10, 130), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        quant_kernel.quantize_rows_stochastic(
            torch.zeros((10, 128), device=cuda, dtype=torch.float64))


@pytest.mark.parametrize("b", [1, 64])
def test_int8_scores_on_the_card_equal_the_cpu(cuda, b):
    """int8 scores on CUDA (torch._int_mm, the batch padded to 32 rows)
    bit-equal to the CPU's, on a ragged table padded on the fly and on the
    same table padded once as the serving index holds it."""
    unit = torch.as_tensor(_unit(1001, 128, 7))
    values, scales = quantize_rows(unit)
    query = unit[:b] + 0.01
    want = int8_scores(values, scales, query)
    got = int8_scores(values.to(cuda), scales.to(cuda), query.to(cuda))
    pv, ps = pad_table(values.to(cuda), scales.to(cuda))
    padded = int8_scores(pv, ps, query.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (b, 1001) and padded.shape == (b, 1008)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(padded[:, :1001].cpu(), want)
    assert not padded[:, 1001:].any()
    # the second operand's two layouts: the port passes the column-major
    # view values.t(); a row-major copy of it gives the same sums
    q8 = torch.randint(-127, 128, (32, 128), dtype=torch.int8, device=cuda)
    assert torch.equal(torch._int_mm(q8, pv.t()),
                       torch._int_mm(q8, pv.t().contiguous()))
