"""K3's bf16x forms (an f32 table in one or three bf16 passes under
``GCN_TPU_MATMUL_PRECISION`` default / high) at the edges of the 16-bit
core's schedule (csrc/agg_tc.cuh ``run16``), against their plain
version on the card at the bars of tests/test_torch_tools_gpu.py's
``_bf16x_holds`` (within 1e-4 of ``conv_aggregate_plain(..., passes)``,
within 4x its error a pass against float64 of the same rounded function,
node 3's all-zero weights giving a zero row, the backward in the same
passes within 1e-3 of float64 autograd):

* T = 1 (64 nodes a row tile), 3, 10 and 64 (one);
* Din 8 and 72 (one k chunk, a part chunk), 192 / 256, 448 / 512 (the
  three-pass rows' resident limit and the first streamed width), 640 /
  704, 896 / 960 (the same for one pass) and 1024 (deep rows: the core's
  partial sums promoted 16 times);
* H 4, 200 and 260 (a last column tile of 4, 72 or 4 columns);
* a batch whose last block pair has no second row tile, one row tile
  alone, and a batch of many tiles a block, so that the A slots, the Wq
  stages and their barriers wrap around many times;
* ids drawn over the whole table, as the gathers of a sweep read them.

Two calls are bit-equal, and the grid the card's launch takes
(``ops.dma_agg.card_schedule``) keeps rows resident exactly where a row
tile's k chunks fit the A slots (Din <= 896; three passes, two slots a
chunk, Din <= 448) and covers every tile.  The 16-bit table forms are held
at the float64 bar at the deep edges' shapes, Din 704 and 1024: K3's bf16
form, and K2's projections in every form (bf16, f16, one and three bf16
passes).

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bf16x_gpu.py
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.ops import dma_agg
from test_torch_tools_gpu import PASSES, _bf16x_holds, cuda  # noqa: F401

pytestmark = pytest.mark.gpu


def _args(device, b, t, din, h, seed, n=None):
    """A seeded table of n rows (default b * t), ids over all of it,
    seeded weights with node 3's all zero, Wq and bq."""
    rng = np.random.default_rng(seed)
    n = n or b * t
    w = rng.random((b, t)).astype(np.float32)
    w[3] = 0.0
    return [torch.as_tensor(a, device=device) for a in (
        rng.normal(size=(n, din)).astype(np.float32),
        rng.integers(0, n, size=(b, t), dtype=np.int32), w,
        (rng.normal(size=(h, din)) * 0.05).astype(np.float32),
        np.full(h, 0.3, np.float32))]


EDGES = [  # (B, T, Din, H, need_dh)
    pytest.param(300, 1, 128, 1024, True, id="T1"),
    pytest.param(6, 64, 256, 512, True, id="T64"),
    pytest.param(100, 10, 8, 260, True, id="din8_h260"),
    pytest.param(301, 3, 128, 200, True, id="T3_h200"),
    pytest.param(61, 10, 448, 200, False, id="din448"),
    pytest.param(61, 10, 896, 200, False, id="din896"),
    pytest.param(61, 10, 960, 512, False, id="din960"),
    pytest.param(4224, 10, 64, 1024, False, id="many_tiles"),
    pytest.param(100, 10, 72, 1024, False, id="din72"),
    pytest.param(60, 10, 192, 512, False, id="din192"),
    pytest.param(60, 10, 256, 512, True, id="din256"),
    pytest.param(60, 10, 640, 260, False, id="din640"),
    pytest.param(60, 10, 704, 1024, False, id="din704"),
    pytest.param(120, 10, 512, 512, True, id="din512"),
    pytest.param(20, 10, 1024, 260, False, id="din1024"),
    pytest.param(50, 10, 128, 4, True, id="h4"),
    pytest.param(18, 10, 128, 1024, True, id="pair_without_second_tile"),
    pytest.param(4, 10, 512, 4, False, id="one_row_tile")]


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("b,t,din,h,need_dh", EDGES)
def test_k3_bf16x_at_the_schedule_edges(cuda, passes, b, t, din, h,
                                        need_dh):
    args = _args(cuda, b, t, din, h, seed=b * t + din + h + passes)
    _bf16x_holds(cuda, args, "dma", passes, need_dh)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("b,t,din,h", [(4224, 10, 128, 1024),
                                       (37, 64, 1024, 260)],
                         ids=["wide_deep", "deep_rows"])
def test_k3_bf16x_two_calls_are_bit_equal(cuda, passes, b, t, din, h):
    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.utils import precision

    args = _args(cuda, b, t, din, h, seed=7, n=20000)
    with torch.inference_mode(), precision.override(PASSES[passes]):
        first = agg.conv_aggregate(*args, mode="dma")
        second = agg.conv_aggregate(*args, mode="dma")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,t,din,h", [(4224, 10, 128, 1024),
                                       (384, 10, 256, 1024),
                                       (4224, 10, 512, 512), (18, 10, 8, 4),
                                       (60, 10, 448, 200),
                                       (60, 10, 512, 260),
                                       (60, 10, 896, 260),
                                       (60, 10, 960, 512),
                                       (60, 10, 640, 260),
                                       (60, 10, 704, 1024),
                                       (6, 64, 1024, 260)])
def test_the_card_schedule_covers_every_tile(cuda, b, t, din, h):
    n_col = -(-h // 128)
    for passes, deepest in ((0, 896), (1, 896), (3, 448)):
        for kind, rows, row_tiles in (("dma", b, -(-b // (64 // t))),
                                      ("project", 20000, -(-20000 // 64))):
            sc = dma_agg.card_schedule(kind, rows, din, h, t, passes)
            assert sc["resident"] == (din <= deepest), (kind, passes, sc)
            assert n_col % sc["groups"] == 0, (kind, sc)
            assert sc["items"] == -(-row_tiles // 2) * sc["groups"], (kind,
                                                                      sc)
            assert sc["blocks"] == 2 * min(sc["items"], sc["clusters"]), (
                kind, sc)


@pytest.mark.parametrize("b,t,din,h", [(60, 10, 704, 1024),
                                       (20, 10, 1024, 260)],
                         ids=["din704", "din1024"])
def test_k3_bf16_table_error_vs_float64_at_the_deep_edges(cuda, b, t, din,
                                                          h):
    """The bf16 table form on the same rounded inputs as the one-pass
    edge cases of those shapes: within 4x the plain f32 version's max
    error against float64."""
    from gcn_song_embeddings_tpu_torch.ops import agg

    tab, ids, w, wq, bq = _args(cuda, b, t, din, h, seed=b * t + din + h + 1)
    tab, wq = tab.bfloat16(), wq.bfloat16()
    before = dma_agg.launches_bf16
    with torch.inference_mode():
        got = agg.conv_aggregate(tab, ids, w, wq, bq, mode="dma")
        plain = agg.conv_aggregate_plain(tab, ids, w, wq, bq)
        ref = agg.conv_aggregate_plain(tab.double(), ids, w.double(),
                                       wq.double(), bq.double())
    torch.cuda.synchronize()
    assert dma_agg.launches_bf16 == before + 1
    err = float((got.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    assert err <= 4 * plain_err, (err, plain_err)


@pytest.mark.parametrize("form", ["bf16", "f16", "bf16x1", "bf16x3"])
@pytest.mark.parametrize("b,t,din,h", [(60, 10, 704, 1024),
                                       (20, 10, 1024, 260)],
                         ids=["din704", "din1024"])
def test_k2_16bit_projection_error_vs_float64_at_the_deep_edges(
        cuda, form, b, t, din, h):
    """K2 (its projection of every table row, then the f32 gather) in each
    16-bit-core form on the deep edges' shapes: within 4x a pass the plain
    f32 version's max error against float64 of the same rounded
    function."""
    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.utils import precision

    tab, ids, w, wq, bq = _args(cuda, b, t, din, h, seed=b * t + din + h + 2)
    passes = {"bf16x1": 1, "bf16x3": 3}.get(form)
    if passes is None:
        dtype = torch.bfloat16 if form == "bf16" else torch.float16
        tab, wq = tab.to(dtype), wq.to(dtype)
    counts = agg.kernel_launches_bf16x1 if form == "bf16x1" else (
        agg.kernel_launches_bf16x3 if form == "bf16x3" else
        agg.kernel_launches_bf16 if form == "bf16" else
        agg.kernel_launches_f16)
    before = counts["project"]
    with torch.inference_mode(), precision.override(PASSES.get(passes)):
        got = agg.conv_aggregate(tab, ids, w, wq, bq, mode="stream")
    with torch.inference_mode():
        plain = agg.conv_aggregate_plain(tab, ids, w, wq, bq, passes)
        ref = agg.conv_aggregate_plain(tab.double(), ids, w.double(),
                                       wq.double(), bq.double(), passes)
    torch.cuda.synchronize()
    assert counts["project"] == before + 1
    err = float((got.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    assert err <= 4 * (passes or 1) * plain_err, (err, plain_err)
