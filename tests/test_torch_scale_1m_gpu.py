"""The 1M-catalog modules on the card at a small size: ``scale_demo``,
``refresh_1m`` and ``hybrid_1m`` on a tiny capstone work dir, and
``serve_bench`` in each form, each launching its kernels.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX, so they
run on a machine without it::

    python -m pytest --noconftest -m gpu tests/test_torch_scale_1m_gpu.py
"""

import json

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch import (
    hybrid_1m,
    refresh_1m,
    scale_demo,
    serve_bench,
)
from gcn_song_embeddings_tpu_torch.ops import (
    agg,
    dma_agg,
    quant_kernel,
    walk_kernel,
)
from torch_capstone import CAPSTONE, TINY

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _launches():
    return (walk_kernel.launches, agg.launches, dma_agg.launches,
            quant_kernel.launches)


@pytest.fixture(scope="module")
def capstone(cuda, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("capstone_gpu"))
    before = _launches()
    sd = scale_demo.run(scale_demo.parse_args(
        [*CAPSTONE, *TINY, "--work-dir", work]), log=lambda *a: None)
    after = _launches()
    return work, sd, [a - b for a, b in zip(after, before)]


def test_scale_demo_on_the_card(capstone):
    work, sd, (k1, k2, k3, _) = capstone
    # at 2,000 tracks the frontier of a B=128, T=10 step outgrows the
    # catalog, so train.fullgraph_forward="auto" trains on K2, not K3
    assert sd.trainer.fullgraph
    assert k1 > 0 and k2 > 0 and k3 == 0
    assert sd.emb.shape == (2000, 128) and np.isfinite(sd.emb).all()
    assert sd.summary["n_tracks"] == 2000
    ratio = sd.summary["pinsage_over_features_hit100"]
    assert ratio > 0 and np.isfinite(ratio)
    assert sd.trainer.device.type == "cuda"


def test_refresh_1m_on_the_card(capstone):
    work = capstone[0]
    before = walk_kernel.launches
    run = refresh_1m.run(refresh_1m.parse_args(
        ["--work-dir", work, "--pair-counts", "10,100", "--parity-sample",
         "64"]), log=lambda *a: None)
    assert walk_kernel.launches > before
    assert run.standing_cached
    assert run.unaffected_equal == {10: True, 100: True}
    assert run.result["platform"] == torch.cuda.get_device_name(0)
    assert abs(run.result["tv_refresh_vs_full"]
               - run.result["tv_seed_noise"]) < 0.05


def test_hybrid_1m_on_the_card(capstone):
    work = capstone[0]
    before = _launches()
    hr = hybrid_1m.run(hybrid_1m.parse_args(["--work-dir", work]),
                       log=lambda *a: None)
    k1, k2, _, _ = (a - b for a, b in zip(_launches(), before))
    assert k1 > 0 and k2 > 0
    for K in (10, 100, 500):
        assert hr.rows["hybrid"][f"hit@{K}"] >= hr.rows["walk"][f"hit@{K}"]
    assert hr.walk[1].shape == (len(hr.queries), 1000)


@pytest.mark.parametrize("extra", [[], ["--int8"], ["--hybrid"],
                                   ["--hybrid", "--cached-head"],
                                   ["--adds", "2"]],
                         ids=["f32", "int8", "live_walk", "cached_head",
                              "adds"])
def test_serve_bench_on_the_card(cuda, extra, capsys):
    before = walk_kernel.launches
    summary = serve_bench.main(["--tracks", "20000", "--queries", "10",
                                "--clients", "4", "--batch", "16",
                                "--hops", "200", *extra])
    assert json.loads(capsys.readouterr().out) == summary
    assert summary["platform"] == torch.cuda.get_device_name(0)
    assert summary["concurrent"]["total_queries"] == 40
    if "--hybrid" in extra:
        assert walk_kernel.launches > before
