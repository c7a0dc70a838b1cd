"""The learning check on the hard dataset, through the port, on the CPU.

Mirror of ``tests/test_hard_synth.py`` ``test_pinsage_beats_features``:
the port's ``make_hard_dataset`` at that fixture's exact arguments
(4,000 tracks, features that reveal only a coarse genre group, positives
mostly same-artist co-listens), the port's ``PinSageTrainer`` on the
same 2 x 300 schedule and overrides, and the port's ``rank_eval``.  The
bars are the JAX test's: PinSage reaches at least 1.5x raw-feature kNN
on hit@100 and on mrr@1000.  The port draws its own random numbers, so
this is a quality bar, not bit-equality; the features row, which has no
randomness, equals the JAX package's ``rank_eval`` within 1e-6.

The dataset's structure is held byte-identical to the JAX generator's by
``tests/test_torch_data.py``, so its structural tests are not repeated.
"""

import os

import numpy as np
import pytest

from gcn_song_embeddings_tpu.evals.device_eval import rank_eval as j_rank_eval
from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.data.synth import make_hard_dataset
from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from torch_threads import one_torch_thread  # noqa: F401

BAR = 1.5           # the JAX test's PinSage / features bar
FEATURES_ATOL = 1e-6


@pytest.fixture(scope="module")
def hard_dir(tmp_path_factory) -> str:
    out = tmp_path_factory.mktemp("data") / "dataset_hard"
    return make_hard_dataset(
        str(out), n_tracks=4000, tracks_per_artist=20, artists_per_genre=10,
        genres_per_group=2, n_collections=800, n_positives=16000,
        feature_dim=64, seed=1)


@pytest.fixture(scope="module")
def hard(hard_dir):
    g = SongGraph(hard_dir,
                  features_file=os.path.join(hard_dir, "features.npy"))
    train_pos, test_pos = g.load_positives_split(
        os.path.join(hard_dir, "positives.json"))
    return g, train_pos, test_pos[:2000]


def test_features_row_equals_jax(hard):
    g, _, test_pos = hard
    got = rank_eval(g.features, test_pos, hit_ks=(100,), mrr_k=1000,
                    batch=2048, device="cpu")
    want = j_rank_eval(g.features, test_pos, hit_ks=(100,), mrr_k=1000,
                       batch=2048)
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= FEATURES_ATOL, (key, got, want)


def test_pinsage_beats_features(hard_dir, hard):
    """End-to-end learning check: graph model >= 1.5x raw-feature kNN."""
    g, train_pos, test_pos = hard
    dg = DeviceGraph.from_graph(g, "cpu")
    r_feat = rank_eval(g.features, test_pos, hit_ks=(100,), mrr_k=1000,
                       batch=2048, device="cpu")
    cfg = config_with_overrides(RunConfig(run_name="hard_test"), {
        "train.epochs": 2,
        "train.batches_per_epoch": 300,
        "train.lr": 1e-3,
        "train.margin": 0.1,
        "walk.batch_walkers": 2048,
    })
    trainer = PinSageTrainer(
        dg, g.n_items, g.features, train_pos, cfg=cfg,
        base_run_dir=os.path.join(hard_dir, "runs"),
        nbhds_path=os.path.join(hard_dir, "neighborhoods.npz"),
        log=False, load_save=False, verbose=False)
    trainer.train()
    emb = trainer.embed()
    assert emb.shape == (g.n_items, cfg.model.out_dim)
    assert np.isfinite(emb).all()
    r_ps = rank_eval(emb, test_pos, hit_ks=(100,), mrr_k=1000, batch=2048,
                     device="cpu")

    assert r_ps["hit@100"] >= BAR * r_feat["hit@100"], (r_ps, r_feat)
    assert r_ps["mrr@1000"] >= BAR * r_feat["mrr@1000"], (r_ps, r_feat)
