"""The bf16 forms of K2 and K3 (on the 16-bit core of ``csrc/agg_tc.cuh``,
which tests/test_torch_f16_gpu.py holds in both 16-bit types) against
their plain versions on the card, the bf16 train step on the card
against the CPU, and the tail's device paths (``profiling.Timer`` with
CUDA events, the crawl's K1).

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bf16_gpu.py

Tolerances: the kernels' outputs within 1e-4 of the plain version (bf16
products are exact in f32; the tensor cores sum them in another order),
gradients within one bf16 ulp (rtol 2^-7, atol 1e-6: both round the same
f32 gradient to bf16, and a sum in another order may round the other
way), entries beyond counted and held under 0.1 %.
"""

import copy

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.models import pinsage as tp
from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg, walk_kernel
from gcn_song_embeddings_tpu_torch.train import trainer as ttrainer

pytestmark = pytest.mark.gpu

AGG_ATOL = 1e-4
GRAD = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, b, t, n, din, hdim, seed=0, zero_row=None,
             w_dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.randn((n, din), generator=g).bfloat16()
    ids = torch.randint(0, n, (b, t), generator=g, dtype=torch.int32)
    w = torch.rand((b, t), generator=g)
    if zero_row is not None:
        w[zero_row] = 0.0
    Wq = (torch.randn((hdim, din), generator=g) * 0.05).bfloat16()
    bq = torch.full((hdim,), 0.3).bfloat16().float()
    return tuple(x.to(dev) for x in (h, ids, w.to(w_dtype), Wq, bq))


@pytest.mark.parametrize("hdim,din", [(512, 512), (512, 128), (132, 24),
                                      (16, 64)])
def test_tile_wq_bf16_kernel_bit_identical(cuda, hdim, din):
    Wq = torch.randn((hdim, din), device=cuda).bfloat16()
    got = agg.tile_wq16(Wq)
    want = agg.tile_wq_plain(Wq)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("mode", ["dma", "stream"])
@pytest.mark.parametrize("b,t,n,din,hdim,zero_row", [
    (4224, 10, 4608, 512, 512, 7),     # the step's layer 0 (full width)
    (384, 10, 4224, 128, 512, None),   # layer 1's widths, bf16
    (65, 3, 300, 24, 16, 0), (7, 64, 100, 40, 20, None),
    (1, 1, 1, 8, 4, None),
    # T = 3 and 1 at H 200 with Din at the resident limit (896) and the
    # first streamed width (960), odd row-tile counts; many tiles a block
    # (the A slots and Wq stages wrap many times)
    (2001, 3, 4000, 896, 200, 2000), (97, 1, 3000, 960, 200, 3),
    (4224, 10, 20000, 128, 1024, 4223)])
def test_bf16_agg_kernels_match_plain(cuda, mode, b, t, n, din, hdim,
                                      zero_row):
    h, ids, w, Wq, bq = _problem(cuda, b, t, n, din, hdim, zero_row=zero_row)
    counter = (dma_agg, "launches_bf16") if mode == "dma" else (
        agg, "launches_bf16")
    before = getattr(*counter)
    with torch.inference_mode():
        got = agg.conv_aggregate(h, ids, w, Wq, bq, mode=mode)
        want = agg.conv_aggregate_plain(h, ids, w, Wq, bq)
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=AGG_ATOL)
    if zero_row is not None:
        assert torch.equal(got[zero_row], want[zero_row])


@pytest.mark.parametrize("mode", ["dma", "stream"])
@pytest.mark.parametrize("t", [10, 64])
def test_bf16_core_at_full_width_on_permuted_ids(cuda, mode, t):
    """The 16-bit core at the step's widths (Din = H = 512) on distinct,
    permuted ids (no contiguous run to gather) and a partial last node
    tile: within 1e-4 of the plain version, and its error against float64
    on the same bf16 inputs within 4x the plain version's (each row's 512
    products summed in the tensor cores' accumulator, no promotion)."""
    b = 700 if t == 10 else 100
    h, _, w, Wq, bq = _problem(cuda, b, t, 8000, 512, 512, seed=5,
                               zero_row=b - 1)
    g = torch.Generator(device="cpu").manual_seed(6)
    ids = torch.randperm(8000, generator=g)[:b * t].to(torch.int32)
    ids = ids.reshape(b, t).to(cuda)
    with torch.inference_mode():
        got = agg.conv_aggregate(h, ids, w, Wq, bq, mode=mode)
        want = agg.conv_aggregate_plain(h, ids, w, Wq, bq)
        ref = agg.conv_aggregate_plain(h.double(), ids, w.double(),
                                       Wq.double(), bq.double())
    torch.testing.assert_close(got, want, rtol=0, atol=AGG_ATOL)
    assert torch.equal(got[b - 1], want[b - 1])
    err = float((got.double() - ref).abs().max())
    plain_err = float((want.double() - ref).abs().max())
    assert err <= 4 * plain_err, (err, plain_err)


def test_bf16_k2_takes_bf16_weights_with_the_bf16_denominator(cuda):
    """The full-graph form: bf16 weights, their sum rounded to bf16."""
    h, ids, w, Wq, bq = _problem(cuda, 3000, 10, 3000, 512, 512, seed=1,
                                 zero_row=11, w_dtype=torch.bfloat16)
    with torch.inference_mode():
        got = agg.conv_aggregate(h, ids, w, Wq, bq, block_rows=1024)
        want = agg.conv_aggregate_plain(h, ids, w, Wq, bq)
        proj = agg.project_table16(h, agg.tile_wq16(Wq), bq)
        rows = agg.slabs_to_rows(proj, 512)
        mean = agg.gather_mean(proj, ids, w, torch.empty_like(got))
    torch.testing.assert_close(got, want, rtol=0, atol=AGG_ATOL)
    torch.testing.assert_close(rows, agg.project_table_plain(h, Wq, bq),
                               rtol=0, atol=AGG_ATOL)
    torch.testing.assert_close(mean, agg.gather_mean_plain(rows, ids, w),
                               rtol=1e-6, atol=1e-7)


def test_bf16_model_aggregate_pads_and_slices_t_past_64(cuda):
    """``tp.aggregate`` on a bf16 table of Din 20 (padded to 24) and
    T = 150 (K3 in slices of at most 64), against the plain version."""
    h, ids, w, Wq, bq = _problem(cuda, 40, 150, 500, 20, 18, seed=2,
                                 zero_row=3)
    with torch.inference_mode():
        for mode in ("dma", "stream"):
            got = tp.aggregate(h, ids, w, Wq, bq, mode=mode)
            torch.testing.assert_close(
                got, agg.conv_aggregate_plain(h, ids, w, Wq, bq), rtol=0,
                atol=AGG_ATOL)


@pytest.mark.parametrize("mode", ["dma", "stream"])
def test_bf16_backward_on_the_card_matches_the_cpu(cuda, mode):
    """ConvAggregate's bf16 backward on the card against the same
    backward on the CPU: dh and dWq bf16, dbq f32, within one bf16 ulp."""
    h, ids, w, Wq, bq = _problem(cuda, 400, 10, 600, 128, 512, seed=3,
                                 zero_row=2)
    cot = torch.randn((400, 512), device=cuda)

    def grads(dev):
        hh, wq, b = (x.to(dev).requires_grad_() for x in (h, Wq, bq))
        out = agg.ConvAggregate.apply(hh, ids.to(dev), w.to(dev), wq, b,
                                      mode, None, None, True)
        return torch.autograd.grad(out, (hh, wq, b), cot.to(dev))

    before = agg.backward_launches[mode + "_bf16"]
    got = grads(cuda)
    assert agg.backward_launches[mode + "_bf16"] == before + 1
    want = grads("cpu")
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    for g, r in zip(got, want):
        bad = ~np.isclose(g.float().cpu().numpy(), r.float().numpy(), **GRAD)
        assert bad.sum() <= 1e-3 * bad.size, (int(bad.sum()), bad.size)


def test_bf16_kernels_refuse_what_they_do_not_take(cuda):
    h, ids, w, Wq, bq = _problem(cuda, 8, 3, 20, 24, 16)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="Wq"):
            agg.conv_aggregate_cuda(h, ids, w, Wq.float(), bq)
        with pytest.raises(ValueError, match="nb_weights"):
            agg.conv_aggregate_cuda(h, ids, w.bfloat16(), Wq, bq, mode="dma")
        with pytest.raises(ValueError, match="multiple"):
            agg.conv_aggregate_cuda(h[:, :12].contiguous(), ids, w,
                                    Wq[:, :12].contiguous(), bq)
        with pytest.raises(ValueError, match="h must be"):
            agg.conv_aggregate_cuda(h.half(), ids, w, Wq, bq)
        with pytest.raises(ValueError, match="bq"):
            agg.conv_aggregate_cuda(h, ids, w, Wq, bq.bfloat16())
        with pytest.raises(ValueError, match="multiple"):
            agg.tile_wq16(Wq[:, :12].contiguous())


def _tables(dev, n=2000, din=64, t=10, seed=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, din)).astype(np.float32)
    w = np.sort(rng.random((n, t)).astype(np.float32), axis=1)[:, ::-1]
    w = np.ascontiguousarray(w)
    w[::9, 5:] = 0.0
    nodes = rng.integers(0, n, (n, t)).astype(np.int32)
    return ttrainer.TrainTables.build(feats, w, nodes, t, dev,
                                      dtype="bfloat16")


@pytest.mark.parametrize("fullgraph", [False, True])
def test_bf16_three_steps_on_the_card_match_the_cpu(cuda, fullgraph):
    """Three bf16 train steps from one init on the card (K3's or K2's
    bf16 form) and on the CPU (plain): losses within 1e-3 relative; every
    master leaf within one bf16 ulp of its value plus 2 lr (Adam moves an
    entry at most ~lr a step)."""
    from gcn_song_embeddings_tpu_torch.config import (
        PinSageConfig,
        TrainConfig,
    )

    tcfg = TrainConfig(lr=1e-3, margin=0.1, batch_size=64,
                       batches_per_epoch=10, dtype="bfloat16")
    mcfg = PinSageConfig(in_dim=64, hidden_dim=128, out_dim=32, T=10)
    gen = torch.Generator().manual_seed(0)
    init = tp.init_pinsage(gen, 2, 64, 128, 32)
    batches = [torch.randint(0, 2000, (64, 3), generator=gen,
                             dtype=torch.int32) for _ in range(3)]
    counts = (dma_agg.launches_bf16, agg.launches_bf16)

    def run(dev):
        params = copy.deepcopy(init).to(dev)
        opt = ttrainer.make_optimizer(params, tcfg)
        tables = _tables(dev)
        losses = [float(ttrainer.train_step(params, opt, b.to(dev), tables,
                                            tcfg, mcfg, fullgraph)[0])
                  for b in batches]
        return losses, {n: p.detach().cpu().numpy()
                        for n, p in params.leaves()}

    card, cpu = run(cuda), run("cpu")
    if fullgraph:
        assert agg.launches_bf16 > counts[1]
    else:
        assert dma_agg.launches_bf16 > counts[0]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-3)
    for name, value in cpu[1].items():
        np.testing.assert_allclose(card[1][name], value, rtol=2 ** -7,
                                   atol=2 * tcfg.lr, err_msg=name)


def test_timer_times_a_cuda_phase_with_events(cuda):
    from gcn_song_embeddings_tpu_torch.utils import profiling

    t = profiling.Timer()
    x = torch.ones((2048, 2048), device=cuda)
    with t.phase("mm", sync_value=x):
        for _ in range(5):
            x = x @ x / 2048.0
    assert t.times["mm"] > 0.0
    profiling.sync(x)


def test_crawl_walk_counts_launches_k1(cuda, tmp_path):
    from gcn_song_embeddings_tpu_torch.data import (
        SongGraph,
        make_synthetic_dataset,
    )
    from gcn_song_embeddings_tpu_torch.data.explore import crawl_walk_counts

    ds = make_synthetic_dataset(str(tmp_path / "ds"), n_tracks=300,
                                n_collections=60, n_positives=600, seed=0)
    graph = SongGraph(ds)
    before = walk_kernel.launches
    out = crawl_walk_counts(graph, start=5, num_steps=2000, top=5,
                            device=cuda)
    assert walk_kernel.launches == before + 1
    assert 0 < len(out) <= 5 and all(n != 5 for n, _ in out)
