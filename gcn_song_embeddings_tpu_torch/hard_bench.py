"""Graph-beats-features benchmark on the hard synthetic dataset.

The port's counterpart of ``scripts/hard_bench.py``, without JAX.  The
uniform-cluster synthetic data saturates at the raw-feature ceiling, so
it cannot show a model learning from the graph.  ``make_hard_dataset``
splits the signal: features reveal only a coarse genre group, positives
are mostly same-artist co-listens, so a model must use playlist
co-membership to rank well::

    synth (hard) -> PPR precompute -> PinSage train -> embed ->
    rank_eval(PinSage) vs rank_eval(raw features)

Prints a JSON summary with the PinSage/features ratios of hit@100 and
mrr@1000 (the acceptance bar is 1.5x)::

    python -m gcn_song_embeddings_tpu_torch.hard_bench [--tracks 20000] \\
        [--epochs 10] [--train-seed 0] [--work-dir DIR] [--device cpu]

A complete dataset in ``<work-dir>/ds`` is reused, and the run resumes
from ``<work-dir>/runs/<run>/state.npz``.  Runs on the GPU unless
``--device`` names another device.
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
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.data.synth import make_hard_dataset
from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device
from gcn_song_embeddings_tpu_torch.utils.profiling import Timer

DATASET_FILES = ("graph.json", "tracks.json", "collections.json",
                 "positives.json", "features.npy")


class HardBench(NamedTuple):
    """A finished run: the printed summary (rounded as the JAX script
    rounds it), its unrounded metrics and phase times, and what a caller
    may reuse."""
    summary: dict
    metrics: dict            # {"features": ..., "pinsage": ...}
    times: dict              # phase -> seconds
    emb: np.ndarray          # PinSage embeddings [n_tracks, out_dim]
    graph: SongGraph
    dg: DeviceGraph
    train_pos: np.ndarray
    test_pos: np.ndarray
    ds_path: str
    trainer: PinSageTrainer  # the trained model


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tracks", type=int, default=20_000)
    ap.add_argument("--collections", type=int, default=4_000)
    ap.add_argument("--positives", type=int, default=60_000)
    ap.add_argument("--feature-dim", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batches-per-epoch", type=int, default=500)
    ap.add_argument("--margin", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hard-negatives", action="store_true")
    ap.add_argument("--hn-min", type=int, default=10)
    ap.add_argument("--hn-max", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0,
                    help="the dataset's seed")
    ap.add_argument("--train-seed", type=int, default=RunConfig().train.seed,
                    help="train.seed: the init's, the batches' and (where "
                         "the work dir holds no sweep yet) the PPR "
                         "sweep's generators")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def bench_config(args: argparse.Namespace) -> RunConfig:
    """The run's config: ``RunConfig()`` with the benchmark's schedule,
    margin, lr, 8192 walkers a sweep block, the hard-negative band and
    ``train.seed``; a seed other than the default gets a run of its own."""
    hn = {"train.hard_negatives": True, "train.hn_min": args.hn_min,
          "train.hn_max": args.hn_max} if args.hard_negatives else {}
    run_name = (f"hard_m{args.margin:g}_lr{args.lr:g}"
                + (f"_hn{args.hn_min}-{args.hn_max}"
                   if args.hard_negatives else "")
                + (f"_s{args.train_seed}" if seeded(args) else ""))
    return config_with_overrides(RunConfig(run_name=run_name), {
        "train.epochs": args.epochs,
        "train.batches_per_epoch": args.batches_per_epoch,
        "train.lr": args.lr,
        "train.margin": args.margin,
        "walk.batch_walkers": 8192,
        "train.seed": args.train_seed,
        **hn,
    })


def seeded(args: argparse.Namespace) -> bool:
    """Whether ``--train-seed`` is other than ``RunConfig``'s."""
    return args.train_seed != RunConfig().train.seed


def run(args: argparse.Namespace, log=print) -> HardBench:
    """The benchmark's phases (synth, load_graph, features_eval,
    precompute, train, embed, eval), each timed on the host clock."""
    dev = resolve_device(args.device)
    log("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else dev)
    work = args.work_dir or tempfile.mkdtemp(prefix="hard_bench_")
    timer = Timer()

    with timer.phase("synth"):
        ds_path = os.path.join(work, "ds")
        if all(os.path.isfile(os.path.join(ds_path, f))
               for f in DATASET_FILES):
            log(f"reusing existing dataset in {ds_path}")
        else:
            make_hard_dataset(
                ds_path, n_tracks=args.tracks,
                n_collections=args.collections,
                n_positives=args.positives,
                feature_dim=args.feature_dim, seed=args.seed)
    with timer.phase("load_graph"):
        g = SongGraph(ds_path,
                      features_file=os.path.join(ds_path, "features.npy"))
        dg = DeviceGraph.from_graph(g, dev)
        train_pos, test_pos = g.load_positives_split(
            os.path.join(ds_path, "positives.json"))
    log(f"graph: {g.n_items} tracks, {g.n_cols} playlists, "
        f"{dg.n_edges} directed edges, {len(test_pos)} test pairs")

    with timer.phase("features_eval"):
        r_feat = rank_eval(g.features, test_pos, hit_ks=(10, 100, 500),
                           mrr_k=1000, batch=4096, device=dev)
    log("raw features:", {k: round(v, 4) for k, v in r_feat.items()})

    cfg = bench_config(args)
    with timer.phase("precompute"):
        trainer = PinSageTrainer(
            dg, g.n_items, g.features, train_pos, cfg=cfg,
            base_run_dir=os.path.join(work, "runs"),
            nbhds_path=os.path.join(ds_path, "neighborhoods.npz"),
            log=True, load_save=True, verbose=False)
    with timer.phase("train"):
        trainer.train()
    with timer.phase("embed"):
        emb = trainer.embed()
    with timer.phase("eval"):
        r_ps = rank_eval(emb, test_pos, hit_ks=(10, 100, 500),
                         mrr_k=1000, batch=4096, device=dev)

    summary = {
        "n_tracks": g.n_items,
        "n_edges": int(dg.n_edges),
        "config": {"epochs": args.epochs, "margin": args.margin,
                   "lr": args.lr, "hard_negatives": args.hard_negatives,
                   **({"hn_min": args.hn_min, "hn_max": args.hn_max}
                      if args.hard_negatives else {}),
                   **({"train_seed": args.train_seed} if seeded(args)
                      else {})},
        "times_s": {k: round(v, 2) for k, v in timer.times.items()},
        "features": {k: round(v, 5) for k, v in r_feat.items()},
        "pinsage": {k: round(v, 5) for k, v in r_ps.items()},
        "pinsage_over_features_hit100":
            round(r_ps["hit@100"] / max(r_feat["hit@100"], 1e-12), 3),
        "pinsage_over_features_mrr":
            round(r_ps["mrr@1000"] / max(r_feat["mrr@1000"], 1e-12), 3),
        "work_dir": work,
    }
    return HardBench(summary, {"features": r_feat, "pinsage": r_ps},
                     dict(timer.times), emb, g, dg, train_pos, test_pos,
                     ds_path, trainer)


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    summary = run(parse_args(argv), log).summary
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
