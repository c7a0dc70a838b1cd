"""The 16-bit core of K2 and K3 (``csrc/agg_tc.cuh``) on the card: the f16
Wq tiling, both 16-bit forms (bf16 and f16) of K3 and K2 against their
plain versions on ragged shapes and against float64, the f16 weights'
rounded denominator, the refusals, the card's 16-bit dh against an
oracle that sums each table row in f32 and rounds once, and three f16
train steps on the card against the CPU.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_f16_gpu.py

Tolerances: the kernels' outputs within 1e-4 of the plain version
(16-bit products are exact in f32; the tensor cores sum them in another
order); their max error against float64 within 4x the plain version's
(tests/test_torch_kernels_gpu.py's bar for the f32 kernels); dh within
one 16-bit ulp of the once-rounded oracle (rtol 2^-7 for bf16, 2^-10 for
f16: the card's f32 sum is rounded once, so only an f32 sum in another
order can put it on the other side of a rounding boundary); 3 steps,
card against CPU: losses within 1e-3 relative, every master leaf within
one f16 ulp plus 2 lr.
"""

import copy

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.models import pinsage as tp
from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg
from gcn_song_embeddings_tpu_torch.train import trainer as ttrainer

pytestmark = pytest.mark.gpu

AGG_ATOL = 1e-4
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
DTYPES = [torch.bfloat16, torch.float16]
COUNTERS = {("dma", torch.bfloat16): (dma_agg, "launches_bf16"),
            ("dma", torch.float16): (dma_agg, "launches_f16"),
            ("stream", torch.bfloat16): (agg, "launches_bf16"),
            ("stream", torch.float16): (agg, "launches_f16")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, dtype, b, t, n, din, hdim, seed=0, zero_rows=(),
             permuted=False, w_dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.randn((n, din), generator=g).to(dtype)
    if permuted:      # distinct, non-contiguous rows
        ids = torch.randperm(n, generator=g)[:b * t].to(torch.int32)
        ids = ids.reshape(b, t)
    else:
        ids = torch.randint(0, n, (b, t), generator=g, dtype=torch.int32)
    w = torch.rand((b, t), generator=g)
    for r in zero_rows:
        w[r] = 0.0
    Wq = (torch.randn((hdim, din), generator=g) * 0.05).to(dtype)
    bq = torch.full((hdim,), 0.3).to(dtype).float()
    return tuple(x.to(dev) for x in (h, ids, w.to(w_dtype), Wq, bq))


@pytest.mark.parametrize("hdim,din", [(512, 512), (512, 128), (132, 24),
                                      (16, 64), (260, 136)])
def test_tile_wq_f16_kernel_bit_identical(cuda, hdim, din):
    Wq = torch.randn((hdim, din), device=cuda).half()
    got = agg.tile_wq16(Wq)
    want = agg.tile_wq_plain(Wq)
    assert got.dtype == torch.float16 and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# (b, t, n, din, hdim, zero_rows, permuted): T = 1 and 64, partial last
# node tiles (the 16-bit core's 64-row tiles hold 64 nodes at T = 1, 1 at
# T = 64), Din 8, H 4 and 100 (and Din 20 / H 18 through ``aggregate``'s
# padding), H 260 (a 256-wide column tile with one Wq tile), Din 136 (a
# partial k chunk), permuted ids, all-zero weight rows; an odd number of
# row tiles (a block pair whose second block has no rows) and one k chunk
# a tile over many tiles a block (the ring's stages and the two consumer
# warpgroups taking turns across tiles); T = 3 at H 200 with Din at the
# resident limit (896) and the first streamed width (960), both with an
# odd row-tile count; and many tiles a block at Din 128, H 1024, so that
# the A slots, the Wq stages and their barriers wrap many times
RAGGED = [(1, 1, 1, 8, 4, (), False),
          (2001, 3, 7000, 896, 200, (5, 2000), True),
          (61, 10, 3000, 960, 200, (0,), False),
          (4224, 10, 45000, 128, 1024, (9,), True),
          (193, 1, 300, 24, 100, (0, 192), False),
          (50, 64, 4000, 8, 100, (49,), True),
          (400, 10, 4000, 40, 4, (3,), True),
          (300, 10, 3000, 136, 260, (0, 299), False),
          (77, 7, 500, 20, 18, (5,), False),
          (3000, 3, 9000, 64, 512, (7, 2999), True)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("mode", ["dma", "stream"])
@pytest.mark.parametrize("b,t,n,din,hdim,zero_rows,permuted", RAGGED)
def test_16bit_core_ragged_shapes_match_plain(cuda, dtype, mode, b, t, n,
                                              din, hdim, zero_rows,
                                              permuted):
    h, ids, w, Wq, bq = _problem(cuda, dtype, b, t, n, din, hdim,
                                 zero_rows=zero_rows, permuted=permuted)
    counter = COUNTERS[mode, dtype]
    before = getattr(*counter)
    with torch.inference_mode():
        got = tp.aggregate(h, ids, w, Wq, bq, mode=mode)
        want = agg.conv_aggregate_plain(h, ids, w, Wq, bq)
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, hdim)
    torch.testing.assert_close(got, want, rtol=0, atol=AGG_ATOL)
    for r in zero_rows:
        assert torch.equal(got[r], want[r])


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("mode", ["dma", "stream"])
def test_16bit_core_error_vs_float64(cuda, dtype, mode):
    """At Din = H = 512 (the step's widths) the kernel sums each row's
    512 products in the tensor cores' accumulator, without promotion:
    its max error against float64 on the same 16-bit inputs is at most
    4x the plain f32 version's."""
    h, ids, w, Wq, bq = _problem(cuda, dtype, 1200, 10, 6000, 512, 512,
                                 seed=11)
    with torch.inference_mode():
        got = agg.conv_aggregate(h, ids, w, Wq, bq, mode=mode)
        plain = agg.conv_aggregate_plain(h, ids, w, Wq, bq)
        ref = agg.conv_aggregate_plain(h.double(), ids, w.double(),
                                       Wq.double(), bq.double())
    err = float((got.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    assert err <= 4 * plain_err, (err, plain_err)


def test_f16_k2_takes_f16_weights_with_the_f16_denominator(cuda):
    """The full-graph form: f16 weights, their f32 sum rounded to f16
    (``__float2half_rn``) before the divide, as ``_denominator``."""
    h, ids, w, Wq, bq = _problem(cuda, torch.float16, 3000, 10, 3000, 512,
                                 512, seed=1, zero_rows=(11,),
                                 w_dtype=torch.float16)
    den = agg._denominator(w)
    w_sum = w.float().sum(dim=1, keepdim=True)
    assert torch.equal(den, torch.where(w_sum == 0, 1.0,
                                        w_sum.half().float()))
    assert (den != torch.where(w_sum == 0, 1.0, w_sum)).any()
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


# (table rows, T, H, nodes): the gather takes 4, 2 and 1 slabs a thread
# as P's slabs of 3,000, 30,000 and 60,000 rows fit L2 four, two and one
# at a time; H 328 leaves 6 slabs (a last slab group of 2 of 4), H 200 a
# last slab of 8 columns; node counts that leave the last block's 16
# nodes ragged
GATHERS = [(3000, 1, 328, 1001), (3000, 3, 200, 2999),
           (30000, 3, 328, 30000), (30000, 1, 1024, 77),
           (60000, 3, 328, 4097), (60000, 1, 200, 60000)]


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,t,hdim,b", GATHERS)
def test_gather_mean_kernel_matches_plain(cuda, w_dtype, n, t, hdim, b):
    """K2's gather-mean alone, with each weight type's denominator (f32
    as it is, bf16 / f16 rounded), against its plain version on the same
    projected slabs; node 0's weights all zero give a zero row.  The
    kernel sums fmaf(w, p, s) where the plain version rounds w p first:
    on unit-normal slabs (|p| up to ~5, an ulp 4.8e-7) the two part by
    a few ulp, 1.9e-7 seen on the card, so atol 1e-6 (the kernels' bar
    against the plain version in this file is AGG_ATOL, 1e-4)."""
    g = torch.Generator(device="cpu").manual_seed(n + t + hdim + b)
    slabs = -(-hdim // agg.SLAB)
    proj = torch.randn((slabs, n, agg.SLAB), generator=g).to(cuda)
    ids = torch.randint(0, n, (b, t), generator=g,
                        dtype=torch.int32).to(cuda)
    w = torch.rand((b, t), generator=g)
    w[0] = 0.0
    w = w.to(w_dtype).to(cuda)
    before = agg.kernel_launches["gather_mean"]
    with torch.inference_mode():
        got = agg.gather_mean(proj, ids, w, torch.empty((b, hdim),
                                                        device=cuda))
        want = agg.gather_mean_plain(agg.slabs_to_rows(proj, hdim), ids, w)
    torch.cuda.synchronize()
    assert agg.kernel_launches["gather_mean"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_l2_read_probe_reads_every_float(cuda):
    """The L2 probe that chip_smoke.py times beside the gather: every one
    of its threads' sums together are ``passes`` reads of the source."""
    src = torch.rand(1 << 20, device=cuda)
    sink = agg.l2_read_probe(src, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(sink.double().sum(), 3 * src.double().sum(),
                               rtol=1e-5, atol=0)


def test_f16_kernels_refuse_what_they_do_not_take(cuda):
    h, ids, w, Wq, bq = _problem(cuda, torch.float16, 8, 3, 20, 24, 16)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="Wq"):
            agg.conv_aggregate_cuda(h, ids, w, Wq.bfloat16(), bq)
        with pytest.raises(ValueError, match="nb_weights"):
            agg.conv_aggregate_cuda(h, ids, w.half(), Wq, bq, mode="dma")
        with pytest.raises(ValueError, match="multiple"):
            agg.conv_aggregate_cuda(h[:, :12].contiguous(), ids, w,
                                    Wq[:, :12].contiguous(), bq)
        with pytest.raises(ValueError, match="T <="):
            agg.conv_aggregate_cuda(h, ids.repeat(1, 22), w.repeat(1, 22),
                                    Wq, bq, mode="dma")
        with pytest.raises(ValueError, match="bq"):
            agg.conv_aggregate_cuda(h, ids, w, Wq, bq.half())
        with pytest.raises(ValueError, match="Wq must be"):
            agg.tile_wq16(Wq.float())
        with pytest.raises(ValueError, match="multiple"):
            agg.tile_wq16(Wq[:, :12].contiguous())
        with pytest.raises(ValueError, match="tiles"):
            agg.project_table16(h, agg.tile_wq16(Wq.bfloat16()), bq)
        with pytest.raises(ValueError, match="h must be"):
            agg.project_table16(h.float(), agg.tile_wq16(Wq), bq)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("mode", ["dma", "stream"])
def test_16bit_dh_is_the_once_rounded_row_sum(cuda, dtype, mode):
    """A deliberate divergence from JAX: the card's dh sums each table
    row's gradient in f32 and rounds once to the table's type (JAX, and
    the CPU path, round each gathered row's gradient and accumulate in 16
    bits).  Held to an oracle that sums each table row exactly (float64)
    on the backward's own leaky_relu branches (the f32 pre-activation of
    the forward, whose residual the backward reads) and rounds once:
    within one 16-bit ulp (ids repeat, so each table row sums several
    gathered rows)."""
    h, ids, w, Wq, bq = _problem(cuda, dtype, 400, 10, 600, 128, 512,
                                 seed=3, zero_rows=(2,))
    cot = torch.randn((400, 512), device=cuda)
    hh, wq, b = (x.detach().clone().requires_grad_() for x in (h, Wq, bq))
    out = agg.ConvAggregate.apply(hh, ids, w, wq, b, mode, None, None,
                                  True)
    dh, = torch.autograd.grad(out, (hh,), cot)
    flat = ids.reshape(-1).long()
    kept = agg.conv_aggregate_slopes(h, ids, w, Wq, bq, mode)
    dq = ((w / agg._denominator(w))[:, :, None]
          * cot[:, None, :]).reshape(kept.shape).double()
    dpre = torch.where(kept, dq, 0.01 * dq)
    rows = torch.zeros((h.shape[0], 512), dtype=torch.float64,
                       device=cuda).index_add_(0, flat, dpre)
    oracle = (rows @ Wq.double()).to(dtype)
    assert dh.dtype == dtype
    bad = ~torch.isclose(dh.float(), oracle.float(), rtol=ULP[dtype],
                         atol=1e-6)
    assert int(bad.sum()) == 0, (int(bad.sum()), bad.numel())


def _tables(dev, n=2000, din=64, t=10, seed=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, din)).astype(np.float32)
    w = np.sort(rng.random((n, t)).astype(np.float32), axis=1)[:, ::-1]
    w = np.ascontiguousarray(w)
    w[::9, 5:] = 0.0
    nodes = rng.integers(0, n, (n, t)).astype(np.int32)
    return ttrainer.TrainTables.build(feats, w, nodes, t, dev,
                                      dtype="float16")


@pytest.mark.parametrize("fullgraph", [False, True])
def test_f16_three_steps_on_the_card_match_the_cpu(cuda, fullgraph):
    """Three f16 train steps from one init on the card (K3's or K2's f16
    form) and on the CPU (plain): losses within 1e-3 relative; every
    master leaf within one f16 ulp of its value plus 2 lr."""
    from gcn_song_embeddings_tpu_torch.config import (
        PinSageConfig,
        TrainConfig,
    )

    tcfg = TrainConfig(lr=1e-3, margin=0.1, batch_size=64,
                       batches_per_epoch=10, dtype="float16")
    mcfg = PinSageConfig(in_dim=64, hidden_dim=128, out_dim=32, T=10)
    gen = torch.Generator().manual_seed(0)
    init = tp.init_pinsage(gen, 2, 64, 128, 32)
    batches = [torch.randint(0, 2000, (64, 3), generator=gen,
                             dtype=torch.int32) for _ in range(3)]
    counts = (dma_agg.launches_f16, agg.launches_f16)

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
        assert agg.launches_f16 > counts[1]
    else:
        assert dma_agg.launches_f16 > counts[0]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-3)
    for name, value in cpu[1].items():
        np.testing.assert_allclose(card[1][name], value, rtol=2 ** -10,
                                   atol=2 * tcfg.lr, err_msg=name)
