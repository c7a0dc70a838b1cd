"""The wide co-listen arm over training seeds: the port against the JAX
package, on the CPU.

On the card the port's ``co1_T10_wide`` arm (``colisten_ab.ARMS``:
``walk.colisten_copies`` 1, ``model.T`` 10, hidden 1024, out 256) reads a
``rank_eval`` mrr@1000 10-14 % under the JAX package's TPU A/B row after
30 x 500 steps at 20,000 tracks.  Here both packages train that arm on
the same 4,000-track hard dataset (the JAX fixture's arguments, as
``tests/test_torch_hard_seeds.py``) with ``TUNED``'s lr and margin, on a
schedule cut to ``STEPS`` steps for the time a CPU test may take, for
each ``train.seed`` of ``SEEDS``, each with its own co-listen PPR sweep.
Each model is scored (``rank_eval`` on the first 2,000 test pairs) at its
init and after training:

* the cut schedule moves both packages' models well away from their
  init (``MOVED_BAR``), so the comparison is of training, not of inits;
* the port's mean mrr@1000 and hit@100 over the seeds must reach
  ``MEAN_BAR`` times JAX's CPU mean.

The two packages draw different random numbers (init, sweep, batches),
so single runs scatter; each run's readings and the means are printed
(``pytest -s``).  What this cannot show is a gap that opens only over
the card's 15,000 steps.
"""

import os

import numpy as np
import pytest

from gcn_song_embeddings_tpu_torch.colisten_ab import ARMS, TUNED
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

ARM = "co1_T10_wide"
SEEDS = range(6)
STEPS = 25
# port's mean over SEEDS / JAX's mean.  Single runs sit about 2-3 %
# (hit@100) and 6-10 % (mrr@1000) from their package's mean (one standard
# deviation), so two six-seed means differ by about 1.5 % (hit@100) and
# 5 % (mrr@1000) by chance alone: the bar lies between that and the
# card's 10-14 %
MEAN_BAR = 0.95
# each package's trained mean over its mean at init
MOVED_BAR = {"hit@100": 1.1, "mrr@1000": 1.3}
METRICS = ("hit@100", "mrr@1000")
OVERRIDES = {**dict(ARMS)[ARM],
             "train.lr": TUNED["train.lr"],
             "train.margin": TUNED["train.margin"],
             "train.epochs": 1, "train.batches_per_epoch": STEPS,
             "walk.batch_walkers": 2048}


@pytest.fixture(scope="module")
def hard_dir(tmp_path_factory) -> str:
    out = tmp_path_factory.mktemp("data") / "dataset_hard"
    return make_hard_dataset(
        str(out), n_tracks=4000, tracks_per_artist=20, artists_per_genre=10,
        genres_per_group=2, n_collections=800, n_positives=16000,
        feature_dim=64, seed=1)


def test_the_overrides_are_the_wide_arms():
    assert OVERRIDES["walk.colisten_copies"] == 1
    assert OVERRIDES["model.T"] == 10
    assert OVERRIDES["model.hidden_dim"] == 1024
    assert OVERRIDES["model.out_dim"] == 256
    assert (OVERRIDES["train.lr"], OVERRIDES["train.margin"]) == (1e-3, 1e-5)


def port_runs(hard_dir: str) -> list[dict]:
    g = SongGraph(hard_dir,
                  features_file=os.path.join(hard_dir, "features.npy"))
    dg = DeviceGraph.from_graph(g, "cpu")
    train_pos, test_pos = g.load_positives_split(
        os.path.join(hard_dir, "positives.json"))
    out = []
    for seed in SEEDS:
        cfg = config_with_overrides(RunConfig(run_name=f"port_s{seed}"),
                                    {**OVERRIDES, "train.seed": seed})
        trainer = PinSageTrainer(
            dg, g.n_items, g.features, train_pos, cfg=cfg,
            base_run_dir=os.path.join(hard_dir, "runs"),
            nbhds_path=os.path.join(hard_dir, f"nbhds_port_s{seed}.npz"),
            log=False, load_save=False, verbose=False)
        assert not trainer.fullgraph  # the frontier forward, as on the card
        row = {}
        for stage in ("init", "trained"):
            if stage == "trained":
                trainer.train()
            ps = rank_eval(trainer.embed(), test_pos[:2000], hit_ks=(100,),
                           mrr_k=1000, batch=2048, device="cpu")
            row[stage] = {k: ps[k] for k in METRICS}
        out.append(row)
    return out


def jax_runs(hard_dir: str) -> list[dict]:
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
    out = []
    for seed in SEEDS:
        cfg = j_overrides(JRunConfig(run_name=f"jax_s{seed}"),
                          {**OVERRIDES, "train.seed": seed})
        trainer = JPinSageTrainer(
            dg, g.n_items, g.features, train_pos, cfg=cfg,
            base_run_dir=os.path.join(hard_dir, "runs"),
            nbhds_path=os.path.join(hard_dir, f"nbhds_jax_s{seed}.npz"),
            log=False, load_save=False, verbose=False)
        row = {}
        for stage in ("init", "trained"):
            if stage == "trained":
                trainer.train()
            emb = np.asarray(trainer.embed(bsize=2048))
            ps = j_rank_eval(emb, test_pos[:2000], hit_ks=(100,),
                             mrr_k=1000, batch=2048)
            row[stage] = {k: ps[k] for k in METRICS}
        out.append(row)
    return out


@pytest.fixture(scope="module")
def runs(hard_dir) -> dict:
    got = {"port": port_runs(hard_dir), "jax": jax_runs(hard_dir)}
    for pkg, rows in got.items():
        for seed, row in zip(SEEDS, rows):
            print(f"{pkg} {ARM} train.seed {seed}: " + "; ".join(
                f"{stage} " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        row[stage].items())
                for stage in row))
    return got


def _mean(rows, metric, stage="trained") -> float:
    return float(np.mean([r[stage][metric] for r in rows]))


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("metric", METRICS)
def test_the_cut_schedule_moves_the_models_from_their_init(runs, pkg,
                                                           metric):
    init = _mean(runs[pkg], metric, "init")
    trained = _mean(runs[pkg], metric)
    print(f"{pkg} {ARM} {metric}: mean at init {init:.4f}, after {STEPS} "
          f"steps {trained:.4f} ({trained / init:.3f}x)")
    assert trained >= MOVED_BAR[metric] * init, (pkg, metric, runs[pkg])


@pytest.mark.parametrize("metric", METRICS)
def test_port_learns_the_wide_arm_as_jax_does_over_seeds(runs, metric):
    port, jax = _mean(runs["port"], metric), _mean(runs["jax"], metric)
    print(f"{ARM} {metric}: mean over {len(SEEDS)} seeds: port "
          f"{port:.4f}, JAX {jax:.4f}, port / JAX {port / jax:.4f}")
    assert port >= MEAN_BAR * jax, (metric, runs)
