"""K3, K2 and their backward at the shapes of the repository tools'
steps, and the bench's yardsticks, against their plain PyTorch versions on
the card.

* ``fullgraph_bench``'s B=4,096 frontier step (N=20,000, Din 512, T=3,
  two layers, hidden 512): the deepest aggregation, 49,152 nodes over
  196,608 gathered feature rows, and the top one, 12,288 nodes over the
  deepest one's 128-d output;
* ``grid_refschedule``'s ``ref`` schedule at four layers (B=128, T=3,
  Din 512, hidden 512): the deepest aggregation, 24,576 nodes over
  98,304 gathered rows, and the one above it, 6,144 nodes over 128-d
  rows;
* ``bench``'s headline step (B=128, T=3, two layers, Din 512, hidden
  512): 1,536 nodes over 6,144 gathered feature rows, then 384 nodes over
  128-d rows;
* ``bench``'s FLOP-bound step (the full graph of N=20,000 tracks, T=3,
  hidden 1024): K2 and its backward at Din 512 (the features) and 256
  (an activation), and K2's bf16 form on bf16 tables, Wq and weights;
* ``agg.gather_read_probe`` (f32 at widths 256, 512 and 1024, bf16 at
  512) and ``agg.l2_read_probe`` over an array larger than L2 against
  float64 sums of what they read;
* the precision policy's bf16x forms (``GCN_TPU_MATMUL_PRECISION``
  default and high: an f32 table in one or three bf16 passes) at the
  wide co-listen arm's shapes (hidden 1024, T=10): Wq's bf16 tiling bit
  for bit, K3 at both aggregations of its frontier step (4,224 nodes
  over 128-d rows, 384 over 256-d ones) and K2 at its two embed layers
  (20,000 rows, Din 128 and 256), each within 1e-4 of the plain version
  at the same passes and within 4x its error a pass against float64 of
  the same rounded function, and the backward in the same passes within 1e-3 of
  float64 autograd of it.

Ids index the table as the frontier forward does (node ``i``'s T
neighbours are rows ``m + i * T ..``).  The forward within 1e-4 of the
plain version, the backward (dh where the table is an activation, dWq,
dbq) within 1e-3 relative of float64 autograd through the plain version,
as tests/test_torch_kernels_gpu.py holds the train step's shapes.  Where
some gathered entry takes another leaky_relu slope in the f32 projection
the backward recomputes than in float64, the reference takes each
entry's slope from that f32 projection (chip_smoke.py's
``branch_slopes``) and every such entry must lie within 1e-5 of 0.  At
the bench's B=128 shape one entry at |pre| = 1.6e-7 takes the other
slope on the card, and that alone moves dWq by 1.5e-3 of its norm.

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
BRANCH_ATOL = 1e-5  # f32 rounding of a Din-term sum near 0


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
    pytest.param(6144, 3, 128, 512, True, id="ref_L4_second"),
    pytest.param(1536, 3, 512, 512, False, id="bench_B128_deep"),
    pytest.param(384, 3, 128, 512, True, id="bench_B128_top")]


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

    for err in _backward_errors(cuda, args, "dma", need_dh, seed=1):
        assert err <= GRAD_RTOL


def _slopes(args) -> torch.Tensor | None:
    """[B*T, H] float64 leaky_relu slopes of the gathered entries as the
    backward takes them (from its f32 ``torch.addmm`` projection), or None
    where every slope is float64's; any entry whose float64 projection
    takes the other slope lies within BRANCH_ATOL of 0."""
    tab, nb, _, Wq, bq = args
    flat = nb.reshape(-1).long()
    pre32 = torch.addmm(bq, tab, Wq.t())[flat]
    pre64 = torch.addmm(bq.double(), tab.double(), Wq.double().t())[flat]
    differ = (pre32 >= 0) != (pre64 >= 0)
    if not differ.any():
        return None
    assert float(pre64[differ].abs().max()) <= BRANCH_ATOL
    return torch.where(pre32 >= 0, 1.0, 0.01).double()


def _backward_errors(cuda, args, mode, need_dh, seed) -> list[float]:
    """The relative Frobenius error of each gradient of the aggregation
    in ``mode`` (dh where ``need_dh``, dWq, dbq) against autograd through
    the plain version in float64 (at the backward's f32 slopes where some
    entry's differs: ``_slopes``); checks that the backward ran once."""
    b, t = args[1].shape
    cot = torch.randn((b, args[3].shape[0]), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(seed))
    slope = _slopes(args)

    def at_slopes(tab, nb, w, Wq, bq):
        pre = torch.addmm(bq, tab, Wq.t())[nb.reshape(-1).long()]
        q = (pre * slope).reshape(b, t, -1)
        return (w[:, :, None] * q).sum(dim=1) / agg._denominator(w)

    def grads(dtype, fn):
        tab, nb, w, Wq, bq = (a if a.dtype == torch.int32
                              else a.to(dtype, copy=True) for a in args)
        inputs = ((tab, Wq, bq) if need_dh else (Wq, bq))
        for x in inputs:
            x.requires_grad_()
        return torch.autograd.grad(fn(tab, nb, w, Wq, bq), inputs,
                                   cot.to(dtype))

    ref = grads(torch.float64,
                agg.conv_aggregate_plain if slope is None else at_slopes)
    del slope
    before = agg.backward_launches[mode]
    got = grads(torch.float32, lambda *a: agg.conv_aggregate(*a, mode=mode))
    torch.cuda.synchronize()
    assert agg.backward_launches[mode] == before + 1
    return [float(torch.linalg.vector_norm(g.double() - r)
                  / torch.linalg.vector_norm(r)) for g, r in zip(got, ref)]


def _fullgraph_args(device, n, t, din, h, seed):
    """A table of n rows, each node's t neighbours drawn from it, seeded
    weights (node 3's all zero), Wq and bq: a full-graph layer."""
    rng = np.random.default_rng(seed)
    w = rng.random((n, t)).astype(np.float32)
    w[3] = 0.0
    return [torch.as_tensor(a, device=device) for a in (
        rng.normal(size=(n, din)).astype(np.float32),
        rng.integers(0, n, (n, t)).astype(np.int32), w,
        (rng.normal(size=(h, din)) * 0.05).astype(np.float32),
        np.full(h, 0.3, np.float32))]


@pytest.mark.parametrize("din,need_dh", [(512, False), (256, True)],
                         ids=["features", "activation"])
def test_k2_and_backward_at_the_flopbound_step(cuda, din, need_dh):
    n, t, h = 20000, 3, 1024
    args = _fullgraph_args(cuda, n, t, din, h, seed=din)
    before = (agg.launches, agg.kernel_launches["project"])
    with torch.inference_mode():
        got = agg.conv_aggregate(*args, mode="stream")
        want = agg.conv_aggregate_plain(*args)
    torch.cuda.synchronize()
    assert (agg.launches, agg.kernel_launches["project"]) == (
        before[0] + 1, before[1] + 1)
    assert float((got - want).abs().max()) <= AGG_ATOL
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    for err in _backward_errors(cuda, args, "stream", need_dh, seed=2):
        assert err <= GRAD_RTOL


@pytest.mark.parametrize("din", [512, 256])
def test_k2_bf16_at_the_flopbound_step(cuda, din):
    tab, nb, w, Wq, bq = _fullgraph_args(cuda, 20000, 3, din, 1024,
                                         seed=din + 1)
    tab, w, Wq = (x.to(torch.bfloat16) for x in (tab, w, Wq))
    before = (agg.launches_bf16, agg.kernel_launches_bf16["project"])
    with torch.inference_mode():
        got = agg.conv_aggregate(tab, nb, w, Wq, bq, mode="stream")
        want = agg.conv_aggregate_plain(tab, nb, w, Wq, bq)
    torch.cuda.synchronize()
    assert (agg.launches_bf16, agg.kernel_launches_bf16["project"]) == (
        before[0] + 1, before[1] + 1)
    assert float((got - want).abs().max()) <= AGG_ATOL


@pytest.mark.parametrize("d,dtype", [(256, torch.float32),
                                     (512, torch.float32),
                                     (1024, torch.float32),
                                     (512, torch.bfloat16)])
def test_gather_probe_sums_the_gathered_rows(cuda, d, dtype):
    n, reps = 20000, 3
    rng = np.random.default_rng(d)
    table = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                            device=cuda).to(dtype)
    idx = torch.as_tensor(rng.integers(0, n, n * 3).astype(np.int32),
                          device=cuda)
    before = agg.probe_launches["gather"]
    got = agg.gather_read_probe(table, idx, reps)
    torch.cuda.synchronize()
    assert agg.probe_launches["gather"] == before + 1
    t64 = table.double()
    rows = [t64[(idx.long() + r) % n] for r in range(reps)]
    want = sum(float(x.sum()) for x in rows)
    scale = sum(float(x.abs().sum()) for x in rows)
    # f32 partial sums of ~2e7 entries, each of them exact in f32
    assert abs(float(got) - want) <= 1e-6 * scale
    assert abs(float(agg.gather_read_probe_plain(table, idx, reps))
               - want) <= 1e-6 * scale


def test_l2_probe_sums_every_pass_of_a_table_larger_than_l2(cuda):
    x = torch.rand(64 * 1024 * 1024, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(3))
    before = agg.probe_launches["l2"]
    got = agg.l2_read_probe(x, 2).sum()
    torch.cuda.synchronize()
    assert agg.probe_launches["l2"] == before + 1
    want = 2 * float(x.double().sum())
    assert float(got) == pytest.approx(want, rel=1e-6)


PASSES = {1: "default", 3: "high"}


@pytest.mark.parametrize("passes", [1, 3])
def test_bf16x_wq_tiling_is_the_plain_tiling(cuda, passes):
    Wq = torch.randn((1024, 256), device=cuda) * 0.05
    before = agg.kernel_launches_bf16x1["tile"] + agg.kernel_launches_bf16x3[
        "tile"]
    hi, lo = agg.tile_wq_bf16x(Wq, passes)
    torch.cuda.synchronize()
    want = [agg.tile_wq_plain(x.bfloat16()) for x in agg.bf16_split3(Wq)]
    assert torch.equal(hi.view(torch.int16), want[0].view(torch.int16))
    if passes == 1:
        assert lo is None
    else:
        assert torch.equal(lo.view(torch.int16), want[1].view(torch.int16))
    assert (agg.kernel_launches_bf16x1["tile"]
            + agg.kernel_launches_bf16x3["tile"]) == before + 1


def _bf16x_holds(cuda, args, mode, passes, need_dh):
    """The bf16x form of ``mode`` on ``args`` against its plain version
    (AGG_ATOL), float64 of the same rounded function (4x the plain
    version's error a pass: the tensor cores sum each pass's Din products
    into the one accumulator, less carefully than an FMA) and its
    backward (GRAD_RTOL of float64 autograd of the same function, the
    cotangent rounded too)."""
    from gcn_song_embeddings_tpu_torch.utils import precision

    form = agg.BF16X[passes]
    counter = (dma_agg, f"launches_{form}") if mode == "dma" else (
        agg, f"launches_{form}")
    before = getattr(*counter)
    with torch.inference_mode(), precision.override(PASSES[passes]):
        got = agg.conv_aggregate(*args, mode=mode)
    with torch.inference_mode():
        want = agg.conv_aggregate_plain(*args, passes)
        ref = agg.conv_aggregate_plain(
            *(a if a.dtype == torch.int32 else a.double() for a in args),
            passes)
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 1
    assert float((got - want).abs().max()) <= AGG_ATOL
    assert float((got.double() - ref).abs().max()) <= 4 * passes * float(
        (want.double() - ref).abs().max())
    assert torch.equal(got[3], torch.zeros_like(got[3]))

    b = args[1].shape[0]
    cot = torch.randn((b, args[3].shape[0]), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(5))

    def grads(dtype, fn):
        tab, nb, w, Wq, bq = (a if a.dtype == torch.int32
                              else a.to(dtype, copy=True) for a in args)
        inputs = ((tab, Wq, bq) if need_dh else (Wq, bq))
        for x in inputs:
            x.requires_grad_()
        return torch.autograd.grad(fn(tab, nb, w, Wq, bq), inputs,
                                   cot.to(dtype))

    ref = grads(torch.float64,
                lambda *a: agg.conv_aggregate_plain(*a, passes))
    before = agg.backward_launches[f"{mode}_{form}"]
    with precision.override(PASSES[passes]):
        got = grads(torch.float32,
                    lambda *a: agg.conv_aggregate(*a, mode=mode))
    torch.cuda.synchronize()
    assert agg.backward_launches[f"{mode}_{form}"] == before + 1
    for g, r in zip(got, ref):
        assert float(torch.linalg.vector_norm(g.double() - r)
                     / torch.linalg.vector_norm(r)) <= GRAD_RTOL


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("m,din,need_dh", [(4224, 128, False),
                                           (384, 256, True)],
                         ids=["deep", "top"])
def test_k3_bf16x_at_the_wide_arms_step(cuda, passes, m, din, need_dh):
    args = _frontier_args(cuda, m, 10, din, 1024, seed=m + passes)
    _bf16x_holds(cuda, args, "dma", passes, need_dh)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("din,need_dh", [(128, False), (256, True)],
                         ids=["features", "activation"])
def test_k2_bf16x_at_the_wide_arms_embed(cuda, passes, din, need_dh):
    args = _fullgraph_args(cuda, 20000, 10, din, 1024, seed=din + passes)
    before = agg.kernel_launches_bf16x1["project"] + \
        agg.kernel_launches_bf16x3["project"]
    _bf16x_holds(cuda, args, "stream", passes, need_dh)
    assert (agg.kernel_launches_bf16x1["project"]
            + agg.kernel_launches_bf16x3["project"]) == before + 2
