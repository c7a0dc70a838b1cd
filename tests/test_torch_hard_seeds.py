"""The learning check over training seeds: the port against the JAX package.

``tests/test_torch_hard_synth.py`` holds one port run to the JAX test's
1.5x bar, which a port that learns a consistent few tens of percent less
than JAX would still clear.  Here both packages train the same 4,000-track
hard dataset (the JAX fixture's arguments) on the same 2 x 300 schedule and
overrides for each of five ``train.seed`` values, each with its own PPR
sweep, and the port's mean PinSage / features ratio must reach
``MEAN_RATIO_BAR`` times JAX's on hit@100 and on mrr@1000.  The two
packages draw different random numbers, so single runs scatter (by up
to a fifth of the ratio from seed to seed); the mean over five seeds is
what is compared.  Each run's ratios are printed (``pytest -s``).
"""

import os

import numpy as np
import pytest

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

SEEDS = range(5)
MEAN_RATIO_BAR = 0.85   # port's mean ratio over SEEDS / JAX's
METRICS = ("hit@100", "mrr@1000")
OVERRIDES = {"train.epochs": 2, "train.batches_per_epoch": 300,
             "train.lr": 1e-3, "train.margin": 0.1,
             "walk.batch_walkers": 2048}


@pytest.fixture(scope="module")
def hard_dir(tmp_path_factory) -> str:
    out = tmp_path_factory.mktemp("data") / "dataset_hard"
    return make_hard_dataset(
        str(out), n_tracks=4000, tracks_per_artist=20, artists_per_genre=10,
        genres_per_group=2, n_collections=800, n_positives=16000,
        feature_dim=64, seed=1)


def port_ratios(hard_dir: str) -> list[dict]:
    g = SongGraph(hard_dir,
                  features_file=os.path.join(hard_dir, "features.npy"))
    dg = DeviceGraph.from_graph(g, "cpu")
    train_pos, test_pos = g.load_positives_split(
        os.path.join(hard_dir, "positives.json"))
    test_pos = test_pos[:2000]
    feat = rank_eval(g.features, test_pos, hit_ks=(100,), mrr_k=1000,
                     batch=2048, device="cpu")
    out = []
    for seed in SEEDS:
        cfg = config_with_overrides(RunConfig(run_name=f"port_s{seed}"),
                                    {**OVERRIDES, "train.seed": seed})
        trainer = PinSageTrainer(
            dg, g.n_items, g.features, train_pos, cfg=cfg,
            base_run_dir=os.path.join(hard_dir, "runs"),
            nbhds_path=os.path.join(hard_dir, f"nbhds_port_s{seed}.npz"),
            log=False, load_save=False, verbose=False)
        trainer.train()
        ps = rank_eval(trainer.embed(), test_pos, hit_ks=(100,),
                       mrr_k=1000, batch=2048, device="cpu")
        out.append({k: ps[k] / feat[k] for k in METRICS})
    return out


def jax_ratios(hard_dir: str) -> list[dict]:
    from gcn_song_embeddings_tpu.config import RunConfig as JRunConfig
    from gcn_song_embeddings_tpu.config import (
        config_with_overrides as j_overrides,
    )
    from gcn_song_embeddings_tpu.data import SongGraph as JSongGraph
    from gcn_song_embeddings_tpu.data.device import (
        DeviceGraph as JDeviceGraph,
    )
    from gcn_song_embeddings_tpu.evals.device_eval import (
        rank_eval as j_rank_eval,
    )
    from gcn_song_embeddings_tpu.train.trainer import (
        PinSageTrainer as JPinSageTrainer,
    )

    g = JSongGraph(hard_dir,
                   features_file=os.path.join(hard_dir, "features.npy"))
    dg = JDeviceGraph.from_graph(g)
    train_pos, test_pos = g.load_positives_split(
        os.path.join(hard_dir, "positives.json"))
    test_pos = test_pos[:2000]
    feat = j_rank_eval(g.features, test_pos, hit_ks=(100,), mrr_k=1000,
                       batch=2048)
    out = []
    for seed in SEEDS:
        cfg = j_overrides(JRunConfig(run_name=f"jax_s{seed}"),
                          {**OVERRIDES, "train.seed": seed})
        trainer = JPinSageTrainer(
            dg, g.n_items, g.features, train_pos, cfg=cfg,
            base_run_dir=os.path.join(hard_dir, "runs"),
            nbhds_path=os.path.join(hard_dir, f"nbhds_jax_s{seed}.npz"),
            log=False, load_save=False, verbose=False)
        trainer.train()
        emb = np.asarray(trainer.embed(bsize=2048))
        ps = j_rank_eval(emb, test_pos, hit_ks=(100,), mrr_k=1000,
                         batch=2048)
        out.append({k: ps[k] / feat[k] for k in METRICS})
    return out


@pytest.fixture(scope="module")
def ratios(hard_dir) -> dict:
    got = {"port": port_ratios(hard_dir), "jax": jax_ratios(hard_dir)}
    for pkg, rows in got.items():
        for seed, row in zip(SEEDS, rows):
            print(f"{pkg} train.seed {seed}: PinSage / features "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    return got


@pytest.mark.parametrize("metric", METRICS)
def test_port_learns_as_jax_does_over_seeds(ratios, metric):
    port = float(np.mean([r[metric] for r in ratios["port"]]))
    jax = float(np.mean([r[metric] for r in ratios["jax"]]))
    print(f"{metric}: mean PinSage / features over {len(SEEDS)} seeds: "
          f"port {port:.4f}, JAX {jax:.4f}, port / JAX {port / jax:.4f}")
    assert port >= MEAN_RATIO_BAR * jax, (metric, ratios)
