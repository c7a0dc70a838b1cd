"""dataset_large-scale end-to-end run (``BASELINE.json`` configs[2]).

The port's counterpart of ``scripts/scale_demo.py``, without JAX.  It
synthesizes a large bipartite graph (100,000 tracks by default; the
capstone runs 1,000,000) and runs the whole pipeline on one device::

    CSR build -> all-node PPR sweep (500 hops, T=100) ->
    PinSage training -> full-catalog embedding -> rank_eval

and prints a JSON summary with each phase's wall and the rates.  The
1M co-listen capstone (``RESULTS.md`` "Co-listen at dataset_large
scale") is::

    python -m gcn_song_embeddings_tpu_torch.scale_demo --hard \\
        --tracks 1000000 --collections 250000 --positives 1000000 \\
        --feature-dim 128 --colisten-copies 1 --T 10 --work-dir DIR

A complete dataset in ``<work-dir>/ds`` is reused (its scale flags are
then ignored) unless it is of the other kind (uniform or ``--hard``), and
the run resumes from ``<work-dir>/runs/<run_name>/state.npz``; the run
name carries ``_co<n>`` and ``_T<T>`` suffixes, so ``hybrid_1m`` finds
it.  Runs on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data import synth
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
from gcn_song_embeddings_tpu_torch.hard_bench import DATASET_FILES
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device
from gcn_song_embeddings_tpu_torch.utils.profiling import Timer

LARGE_MIN = 200_000   # from this many tracks the uniform recipe is the
#                       vectorized make_synthetic_dataset_large
# where refresh_1m and hybrid_1m look for the capstone's work dir by default
CAPSTONE_WORK_DIR = os.path.join(tempfile.gettempdir(), "scale_1m_co")


class Dataset(NamedTuple):
    """A loaded dataset dir: the graph (with its features), the graph on
    the device and the positives' train/test split."""
    graph: SongGraph
    dg: DeviceGraph
    train_pos: np.ndarray
    test_pos: np.ndarray


class ScaleDemo(NamedTuple):
    """A finished run: the printed summary (rounded as the JAX script
    rounds it), its unrounded metrics and phase times, and what a caller
    may reuse."""
    summary: dict
    metrics: dict            # {"pinsage": ..., "features": ... or None}
    times: dict              # phase -> seconds
    emb: np.ndarray          # PinSage embeddings [n_tracks, out_dim]
    data: Dataset
    ds_path: str
    trainer: PinSageTrainer


def load_dataset(ds_path: str, device) -> Dataset:
    """``SongGraph`` of ``ds_path`` with its ``features.npy``, the graph
    on ``device`` and the split of ``positives.json``."""
    g = SongGraph(ds_path, features_file=os.path.join(ds_path,
                                                      "features.npy"))
    train_pos, test_pos = g.load_positives_split(
        os.path.join(ds_path, "positives.json"))
    return Dataset(g, DeviceGraph.from_graph(g, device), train_pos, test_pos)


def platform(dev: torch.device) -> str:
    """The device's name as results name it: the card's, or "cpu"."""
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tracks", type=int, default=100_000)
    ap.add_argument("--collections", type=int, default=20_000)
    ap.add_argument("--clusters", type=int, default=200)
    ap.add_argument("--positives", type=int, default=200_000)
    ap.add_argument("--feature-dim", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batches-per-epoch", type=int, default=500)
    ap.add_argument("--margin", type=float, default=0.1)
    ap.add_argument("--colisten-copies", type=int, default=0,
                    help="materialize train positives as pseudo-"
                         "collections (walk.colisten_copies)")
    ap.add_argument("--T", type=int, default=3, help="model.T fan-out")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hard", action="store_true",
                    help="use make_hard_dataset (hierarchy/power-law "
                         "recipe; features reveal only the genre group) "
                         "and report the raw-features baseline beside "
                         "PinSage")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def run_name(args: argparse.Namespace) -> str:
    """The run's name, which keys its resume checkpoint: margin and lr,
    then ``_co<n>`` with co-listen copies and ``_T<T>`` for T other than
    3 (the parameters' shapes do not depend on T, so an unsuffixed name
    would resume a model of another T)."""
    name = f"scale_demo_m{args.margin:g}_lr{args.lr:g}"
    if args.colisten_copies:
        name += f"_co{args.colisten_copies}"
    if args.T != 3:
        name += f"_T{args.T}"
    return name


def demo_config(args: argparse.Namespace) -> RunConfig:
    """``RunConfig()`` with the run's schedule, lr, margin, co-listen
    copies, T and 8192 walkers a sweep block."""
    return config_with_overrides(RunConfig(run_name=run_name(args)), {
        "train.epochs": args.epochs,
        "train.batches_per_epoch": args.batches_per_epoch,
        "train.lr": args.lr,
        "train.margin": args.margin,
        "walk.batch_walkers": 8192,
        "walk.colisten_copies": args.colisten_copies,
        "model.T": args.T,
    })


def make_dataset(args: argparse.Namespace, ds_path: str, log=print) -> None:
    """Write the dataset into ``ds_path`` unless a complete one is there:
    the hard recipe at dataset_large shape (playlists of 8-400 tracks,
    Pareto alpha 2.0), else the uniform one (vectorized from LARGE_MIN
    tracks), seed 0.  A complete dataset of the other kind is refused."""
    want = "hard" if args.hard else "uniform"
    if all(os.path.isfile(os.path.join(ds_path, f)) for f in DATASET_FILES):
        marker = os.path.join(ds_path, "dataset_kind.txt")
        prev = "uniform"
        if os.path.isfile(marker):
            with open(marker) as f:
                prev = f.read().strip()
        if prev != want:
            raise SystemExit(
                f"work dir {ds_path} holds a {prev!r} dataset but this run "
                f"wants {want!r}; use another --work-dir")
        log(f"reusing existing dataset in {ds_path}")
    elif args.hard:
        synth.make_hard_dataset(
            ds_path, n_tracks=args.tracks, n_collections=args.collections,
            collection_size_range=(8, 400), collection_size_alpha=2.0,
            n_positives=args.positives, feature_dim=args.feature_dim,
            seed=0)
    else:
        make = (synth.make_synthetic_dataset_large
                if args.tracks >= LARGE_MIN
                else synth.make_synthetic_dataset)
        make(ds_path, n_tracks=args.tracks, n_collections=args.collections,
             n_clusters=args.clusters, tracks_per_collection=30,
             n_positives=args.positives, feature_dim=args.feature_dim,
             seed=0)
    with open(os.path.join(ds_path, "dataset_kind.txt"), "w") as f:
        f.write(want)


def run(args: argparse.Namespace, log=print,
        timer: Timer | None = None) -> ScaleDemo:
    """The run's phases (synth, load_graph, precompute, train, embed,
    eval, and features_eval with ``--hard``), each timed on the host
    clock by ``timer`` (default: a new ``Timer``)."""
    dev = resolve_device(args.device)
    log("device:", platform(dev))
    work = args.work_dir or tempfile.mkdtemp(prefix="scale_demo_")
    ds = os.path.join(work, "ds")
    timer = timer or Timer()
    with timer.phase("synth"):
        make_dataset(args, ds, log)
    with timer.phase("load_graph"):
        data = load_dataset(ds, dev)
    g, dg, train_pos, test_pos = data
    log(f"graph: {g.n_items} tracks, {g.n_cols} playlists, "
        f"{dg.n_edges} directed edges")

    cfg = demo_config(args)
    with timer.phase("precompute"):
        trainer = PinSageTrainer(
            dg, g.n_items, g.features, train_pos, cfg=cfg,
            base_run_dir=os.path.join(work, "runs"),
            nbhds_path=os.path.join(ds, "neighborhoods.npz"),
            log=True, load_save=True, verbose=False)
    with timer.phase("train"):
        trainer.train()
    with timer.phase("embed"):
        emb = trainer.embed()
    with timer.phase("eval"):
        results = rank_eval(emb, test_pos, hit_ks=(100, 500), mrr_k=1000,
                            batch=4096, device=dev)
    r_feat = None
    if args.hard:
        with timer.phase("features_eval"):
            r_feat = rank_eval(g.features, test_pos, hit_ks=(100, 500),
                               mrr_k=1000, batch=4096, device=dev)
        log("raw features:", {k: round(v, 5) for k, v in r_feat.items()})

    times = timer.times
    hops = g.n_items * cfg.walk.n_hops
    summary = {
        "n_tracks": g.n_items,
        "n_edges": int(dg.n_edges),
        "times_s": {k: round(v, 2) for k, v in times.items()},
        "precompute_hops_per_s": round(hops / times["precompute"], 0),
        "train_batches_per_s": round(
            args.epochs * args.batches_per_epoch
            / max(times["train"], 1e-9), 1)
        if times["train"] > 1 else None,
        "embed_tracks_per_s": round(g.n_items / times["embed"], 0),
        "eval_pairs_per_s": round(len(test_pos) / times["eval"], 0),
        "metrics": {k: round(v, 5) for k, v in results.items()},
        **({"features_metrics":
            {k: round(v, 5) for k, v in r_feat.items()},
            "pinsage_over_features_hit100":
            round(results["hit@100"] / max(r_feat["hit@100"], 1e-12), 3)}
           if r_feat is not None else {}),
        "work_dir": work,
    }
    return ScaleDemo(summary, {"pinsage": results, "features": r_feat},
                     dict(times), emb, data, ds, trainer)


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    summary = run(parse_args(argv), log).summary
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
