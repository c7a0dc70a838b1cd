"""Grid search at the reference's full training schedule (reproducible).

The port's counterpart of ``scripts/grid_refschedule.py``, without JAX.
Re-creates the JAX script's sweeps on its 20,000-track synthetic catalog
with the port's ``train.grid_search.grid_search``:

* ``ref``: margin x lr x hard negatives x depth (2 / 4 layers), 16
  configs at the reference schedule (30 epochs x 500 batches x 128);
* ``colisten``: margin x lr x ``walk.colisten_copies`` 0 / 1 x
  ``model.T`` 3 / 10, 16 configs at 30 x 500 (run with
  ``--dataset-kind hard``);
* ``quick``: margin x lr x ``model.T`` 3 / 5, 8 configs at 4 x 500.

``--dataset-kind uniform`` builds ``make_synthetic_dataset`` (512-d
cluster features), ``hard`` ``make_hard_dataset`` (power-law playlists,
group-only features).  The dataset lives in ``<work-dir>/ds`` with a
``dataset_kind.txt`` marker; a complete dataset of another kind is
refused (a missing marker reads as ``uniform``, as in the JAX script).
The PPR neighborhood cache is shared by every config through the dataset
dir.  The results, sorted by MRR, go to ``--out`` (default: the JAX
script's file name under the work dir, never ``results/``)::

    python -m gcn_song_embeddings_tpu_torch.grid_refschedule \\
        [--schedule ref|quick|colisten] [--dataset-kind uniform|hard] \\
        [--work-dir DIR] [--out FILE] [--device cpu]

Runs on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.data.synth import (
    make_hard_dataset,
    make_synthetic_dataset,
)
from gcn_song_embeddings_tpu_torch.scale_demo import platform
from gcn_song_embeddings_tpu_torch.train.grid_search import grid_search
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

DATASET_FILES = ("graph.json", "positives.json", "features.npy")


def schedule(name: str, kind: str) -> tuple[int, int, dict, str]:
    """The JAX script's schedule ``name`` on a ``kind`` dataset: (epochs,
    batches per epoch, grid, the default output's file name)."""
    if name == "ref":
        return 30, 500, {"train.margin": [0.1, 1e-5],
                         "train.lr": [1e-4, 1e-3],
                         "train.hard_negatives": [False, True],
                         "model.n_layers": [2, 4]}, (
            "grid_search_hard.json" if kind == "hard"
            else "grid_search_refschedule.json")
    if name == "colisten":
        return 30, 500, {"train.margin": [0.1, 1e-5],
                         "train.lr": [1e-4, 1e-3],
                         "walk.colisten_copies": [0, 1],
                         "model.T": [3, 10]}, (
            "grid_search_colisten_hard.json" if kind == "hard"
            else "grid_search_colisten.json")
    if name == "quick":
        return 4, 500, {"train.margin": [0.1, 1e-5],
                        "train.lr": [1e-4, 1e-3],
                        "model.T": [3, 5]}, "grid_search1.json"
    raise ValueError(f"unknown schedule {name!r}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--schedule", choices=("ref", "quick", "colisten"),
                    default="ref")
    ap.add_argument("--dataset-kind", choices=("uniform", "hard"),
                    default="uniform",
                    help="'hard' = make_hard_dataset (power-law playlists, "
                         "group-only features: the benchmark where "
                         "hyperparameters can actually separate)")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def ensure_dataset(ds_path: str, kind: str) -> None:
    """Reuse the complete dataset of ``ds_path`` if its marker names
    ``kind`` (refuse it otherwise), else build the JAX script's catalog
    of that kind and mark it."""
    marker = os.path.join(ds_path, "dataset_kind.txt")
    if all(os.path.isfile(os.path.join(ds_path, f)) for f in DATASET_FILES):
        prev = "uniform"
        if os.path.isfile(marker):
            with open(marker) as f:
                prev = f.read().strip()
        if prev != kind:
            raise SystemExit(
                f"work dir {ds_path} holds a {prev!r} dataset but "
                f"--dataset-kind is {kind!r}; use a different --work-dir "
                f"(refusing to mislabel results)")
        return
    if kind == "hard":
        make_hard_dataset(ds_path, n_tracks=20_000, n_collections=4_000,
                          n_positives=60_000, seed=0)
    else:
        make_synthetic_dataset(ds_path, n_tracks=20_000,
                               n_collections=4_000, n_clusters=100,
                               tracks_per_collection=30, n_positives=60_000,
                               feature_dim=512, seed=0)
    with open(marker, "w") as f:
        f.write(kind)


def run(args: argparse.Namespace, log=print, base_overrides=None,
        grid=None) -> list[dict]:
    """The schedule's grid search; returns its results sorted by MRR.
    ``base_overrides`` (merged over the schedule's epochs and batches)
    and ``grid`` (in place of the schedule's) cut the run."""
    dev = resolve_device(args.device)
    log("device:", platform(dev))
    work = args.work_dir or tempfile.mkdtemp(prefix="grid_ref_")
    ds_path = os.path.join(work, "ds")
    ensure_dataset(ds_path, args.dataset_kind)
    graph = SongGraph(ds_path,
                      features_file=os.path.join(ds_path, "features.npy"))
    graph.nbhds_path = os.path.join(ds_path, "neighborhoods.npz")
    train_pos, test_pos = graph.load_positives_split(
        os.path.join(ds_path, "positives.json"))

    epochs, bpe, sched_grid, out_name = schedule(args.schedule,
                                                 args.dataset_kind)
    base_cfg = config_with_overrides(
        RunConfig(), {"train.epochs": epochs, "train.batches_per_epoch": bpe,
                      **(base_overrides or {})})
    out = args.out or os.path.join(work, out_name)
    results = grid_search(graph, train_pos, test_pos,
                          grid if grid is not None else sched_grid,
                          base_cfg=base_cfg,
                          base_run_dir=os.path.join(work, "runs_gs"),
                          out_path=out, verbose=True, device=dev)
    best = results[0]
    log(f"best: {best['params']} mrr={best['mrr']:.5f} "
        f"hr@100={best['hit_rate']:.5f} -> {out}")
    return results


def main(argv=None) -> list[dict]:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    return run(parse_args(argv), log)


if __name__ == "__main__":
    main()
