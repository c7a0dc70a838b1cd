"""Controlled A/B: PinSage with co-listen edges + hn curriculum vs CF.

The port's counterpart of ``scripts/colisten_ab.py``, without JAX.  On
the hard benchmark the TrackTrackCF models factorize the train-positive
co-occurrence matrix directly, while PinSage's walks see only playlist
edges.  This runs the signal-asymmetry experiment as a controlled matrix
on ONE shared hard dataset and split (``ensure_hard_dataset``: 20,000
tracks, 4,000 playlists, 60,000 positives, seed 0):

* TrackTrackCF ALS and BPR reference rows (``cf_als``, ``cf_bpr``);
* PageRank control arms (``ppr_plain``, ``ppr_co1``): top-1000 PPR
  lists of 1000-hop walks (alpha 0.85, K1) over the plain and the
  co-listen augmented graph, scored from the lists (``"evaluator":
  "knn_list"``), which separates "the augmented GRAPH carries the
  signal" from "the CONV adds value beyond it";
* the PinSage arms of ``ARMS`` on the tuned 30 x 500 schedule
  (``TUNED``): plain vs ``walk.colisten_copies`` 1 and 3 (x ``model.T``
  3, 10, 20), the hard-negative curriculum (``train.hn_start_epoch``) at
  10 and 30 epochs, and wider models (hidden 1024, out 256 or 512).

PinSage arms are scored with ``rank_eval`` (cosine, f32, tie-fair
average ranks) on every test pair.  One JSON line per arm is appended to
``--out`` (default ``<work-dir>/colisten_ab.jsonl``) as it finishes;
arms already in the file are skipped, so a rerun resumes, and each
PinSage arm resumes from ``<work-dir>/runs/<arm>``::

    python -m gcn_song_embeddings_tpu_torch.colisten_ab \\
        [--work-dir DIR] [--arms cf_als,co1_T10] [--quick] [--device cpu]
        [--train-seed N]

``--train-seed N`` (not in the JAX script) trains every PinSage arm at
``train.seed`` N, as ``<arm>_s<N>`` (its run dir and its row's name)
where N is not 0; the PPR caches in ``<work-dir>/ds`` are shared.  Under
the matmul precision policy (``GCN_TPU_MATMUL_PRECISION``, read by
``utils.precision``) every PinSage row also names it
(``"matmul_precision"``), and a seeded row its ``"train_seed"``.

Runs on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    augment_with_colisten,
)
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.data.synth import ensure_hard_dataset
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
from gcn_song_embeddings_tpu_torch.models.baselines.mf import TrackTrackCF
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    block_generator,
    sample_neighborhood_topt_tables,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    draw_uniforms,
    fused_walk_tables,
)
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from gcn_song_embeddings_tpu_torch.utils import precision
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

TUNED = {  # the hard-grid winner schedule (results/grid_search_hard.json)
    "train.epochs": 30, "train.batches_per_epoch": 500,
    "train.lr": 1e-3, "train.margin": 1e-5,
    "walk.batch_walkers": 8192,
}

ARMS = [
    # --- signal-asymmetry matrix (30-epoch tuned schedule) ---
    ("plain30", {}),
    ("co1", {"walk.colisten_copies": 1}),
    ("co3", {"walk.colisten_copies": 3}),
    ("co1_T10", {"walk.colisten_copies": 1, "model.T": 10}),
    ("co3_T10", {"walk.colisten_copies": 3, "model.T": 10}),
    # --- hn curriculum A/B, 30 epochs ---
    ("hn30", {"train.hard_negatives": True}),
    ("cur30", {"train.hard_negatives": True, "train.hn_start_epoch": 20}),
    ("co1_cur30", {"walk.colisten_copies": 1,
                   "train.hard_negatives": True,
                   "train.hn_start_epoch": 20}),
    # --- hn curriculum A/B, 10 epochs ---
    ("plain10", {"train.epochs": 10}),
    ("hn10", {"train.epochs": 10, "train.hard_negatives": True}),
    ("cur10", {"train.epochs": 10, "train.hard_negatives": True,
               "train.hn_start_epoch": 5}),
    # --- second wave: push the co1_T10 winner further ---
    ("co1_T10_60ep", {"walk.colisten_copies": 1, "model.T": 10,
                      "train.epochs": 60}),
    ("co1_T20", {"walk.colisten_copies": 1, "model.T": 20}),
    ("co1_T10_m01", {"walk.colisten_copies": 1, "model.T": 10,
                     "train.margin": 0.1}),
    ("co1_T10_cur", {"walk.colisten_copies": 1, "model.T": 10,
                     "train.hard_negatives": True,
                     "train.hn_start_epoch": 20}),
    # --- third wave: can a wider embedding capture the precision the
    # augmented-walk PPR control shows is in the graph? ---
    ("co1_T10_wide", {"walk.colisten_copies": 1, "model.T": 10,
                      "model.hidden_dim": 1024, "model.out_dim": 256}),
    ("co1_T10_d512", {"walk.colisten_copies": 1, "model.T": 10,
                      "model.hidden_dim": 1024, "model.out_dim": 512}),
]

CF_ARMS = (("cf_als", "als"), ("cf_bpr", "bpr"))
PPR_ARMS = (("ppr_plain", 0), ("ppr_co1", 1))
# the control arms' walks: PersPageRank's (1000 hops, alpha 0.85), top-1000
# lists, origins in blocks of 2048 (the last padded with its last id)
PPR_HOPS, PPR_ALPHA, PPR_K, PPR_BLOCK = 1000, 0.85, 1000, 2048
HIT_KS, MRR_K, EVAL_BATCH = (10, 100, 500), 1000, 4096


class Data(NamedTuple):
    """The shared dataset: graph, its device CSR, the split, its path."""
    graph: SongGraph
    dg: DeviceGraph
    train_pos: np.ndarray
    test_pos: np.ndarray
    ds_path: str


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "colisten_ab"))
    ap.add_argument("--tracks", type=int, default=20_000)
    ap.add_argument("--collections", type=int, default=4_000)
    ap.add_argument("--positives", type=int, default=60_000)
    ap.add_argument("--out", default=None,
                    help="JSON-lines file (default: "
                         "<work-dir>/colisten_ab.jsonl)")
    ap.add_argument("--arms", default=None,
                    help="comma-separated arm names to run (default all)")
    ap.add_argument("--quick", action="store_true",
                    help="CPU smoke mode: tiny schedules, structure only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--train-seed", type=int, default=0,
                    help="train.seed of the PinSage arms (not 0: each arm "
                         "runs as <arm>_s<N>)")
    return ap.parse_args(argv)


def arm_config(arm: str, overrides: dict, quick: bool = False) -> RunConfig:
    """The arm's ``RunConfig``, named after the arm (its run dir):
    ``TUNED`` under the arm's ``overrides``; ``quick`` shrinks the
    schedule as the JAX script does, keeping ``train.hn_start_epoch``
    strictly inside the shrunk schedule so the gated-hard phase runs."""
    merged = {**TUNED, **overrides}
    if quick:
        merged["train.epochs"] = max(merged["train.epochs"] // 10, 2)
        merged["train.batches_per_epoch"] = 30
        merged["walk.n_hops"] = 100
        merged["walk.batch_walkers"] = 1024
        if "train.hn_start_epoch" in merged:
            merged["train.hn_start_epoch"] = min(
                max(merged["train.hn_start_epoch"] // 10, 1),
                merged["train.epochs"] - 1)
    return config_with_overrides(RunConfig(run_name=arm), merged)


def done_arms(path: str) -> set:
    """Arms already in the JSON-lines file; a line that does not parse
    (or names no arm) is ignored."""
    done = set()
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["arm"])
                except (KeyError, TypeError, json.JSONDecodeError):
                    pass
    return done


def emit(path: str, arm: str, metrics: dict, extra: dict, log=print
         ) -> dict:
    """Append the arm's row: metrics rounded to 5 places, then ``extra``."""
    row = {"arm": arm, **{k: round(v, 5) for k, v in metrics.items()},
           **extra}
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")
    log("RESULT", json.dumps(row))
    return row


def load(args: argparse.Namespace, dev: torch.device, log=print) -> Data:
    """The shared hard dataset of ``<work-dir>/ds`` (made or reused under
    ``ensure_hard_dataset``'s provenance guard) and its split."""
    ds_path = ensure_hard_dataset(
        os.path.join(args.work_dir, "ds"), n_tracks=args.tracks,
        n_collections=args.collections, n_positives=args.positives,
        seed=0, log=log)
    g = SongGraph(ds_path,
                  features_file=os.path.join(ds_path, "features.npy"))
    dg = DeviceGraph.from_graph(g, dev)
    train_pos, test_pos = g.load_positives_split(
        os.path.join(ds_path, "positives.json"))
    log(f"graph: {g.n_items} tracks, {g.n_cols} playlists, "
        f"{dg.n_edges} edges, {len(train_pos)}/{len(test_pos)} "
        f"train/test pairs")
    return Data(g, dg, train_pos, test_pos, ds_path)


def score(emb, test_pos: np.ndarray, dev) -> dict:
    """hit@10/100/500 and mrr@1000 of the embeddings over every test
    pair."""
    return rank_eval(emb, test_pos, hit_ks=HIT_KS, mrr_k=MRR_K,
                     batch=EVAL_BATCH, device=dev)


def cf_metrics(algo: str, data: Data, dev) -> dict:
    """TrackTrackCF(``algo``) fitted on the train split, its item factors
    scored by ``rank_eval``."""
    g = data.graph
    model = TrackTrackCF(algo=algo, device=dev)
    model.train(g, g.track_ids, data.train_pos, data.test_pos, g.features)
    return score(model.model.item_factors, data.test_pos, dev)


def ppr_lists(graph: DeviceGraph, n_items: int, k: int = PPR_K,
              block: int = PPR_BLOCK, hops: int = PPR_HOPS,
              alpha: float = PPR_ALPHA, uniforms=None) -> np.ndarray:
    """Top-``k`` PPR lists [n_items, k] of every track over ``graph``:
    origins in blocks of ``block``, the last padded with its last id,
    each block's [hops, block, 3] uniforms from ``block_generator(0,
    start)`` or, given, from ``uniforms(start)``."""
    dev = graph.device
    if uniforms is None:
        def uniforms(start):
            return draw_uniforms(hops, block,
                                 block_generator(0, start, dev))
    tables = fused_walk_tables(graph)
    knn = np.zeros((n_items, k), np.int32)
    for s in range(0, n_items, block):
        e = min(s + block, n_items)
        ids = np.full((block,), e - 1, np.int32)
        ids[:e - s] = np.arange(s, e, dtype=np.int32)
        _, nodes = sample_neighborhood_topt_tables(
            tables, torch.as_tensor(ids, device=dev), hops, alpha, k,
            uniforms(s).to(dev))
        knn[s:e] = nodes[:e - s].cpu().numpy()
    return knn


def knn_list_metrics(knn: np.ndarray, test_pos: np.ndarray) -> dict:
    """hit@10/100/500 and mrr@1000 of the test pairs from ranked lists."""
    m = {f"hit@{K}": M.hit_rate(knn, test_pos, K) for K in HIT_KS}
    m[f"mrr@{MRR_K}"] = M.mrr(knn, test_pos, MRR_K)
    return m


def ppr_arm_graph(data: Data, copies: int) -> DeviceGraph:
    """The control arm's graph: plain, or with ``copies`` co-listen
    copies of the train pairs."""
    return (data.dg if copies == 0
            else augment_with_colisten(data.dg, data.train_pos, copies))


def pinsage_trainer(data: Data, cfg: RunConfig, work: str,
                    verbose: bool = True) -> PinSageTrainer:
    """The arm's trainer, resuming ``<work>/runs/<arm>``, sharing the
    dataset's PPR caches (``neighborhoods.npz``; the co-listen ones keep
    their ``.colisten<N>`` names)."""
    g = data.graph
    return PinSageTrainer(
        data.dg, g.n_items, g.features, data.train_pos, cfg=cfg,
        base_run_dir=os.path.join(work, "runs"),
        nbhds_path=os.path.join(data.ds_path, "neighborhoods.npz"),
        log=False, load_save=True, verbose=verbose)


def run(args: argparse.Namespace, log=print, data: Data | None = None
        ) -> dict:
    """Every selected arm not yet in the output file, in the JAX script's
    order (CF, PPR controls, PinSage); returns {arm: row} of the arms run
    now."""
    dev = resolve_device(args.device)
    log("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else dev)
    work = args.work_dir
    if data is None:
        data = load(args, dev, log)
    out_path = args.out or os.path.join(work, "colisten_ab.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    done = done_arms(out_path)
    sel = set(args.arms.split(",")) if args.arms else None

    def wanted(arm: str, name: str | None = None) -> bool:
        if (name or arm) in done or (sel is not None and arm not in sel):
            log(f"skip {name or arm}")
            return False
        return True

    seed = args.train_seed
    tags = {**({"train_seed": seed} if seed else {}),
            **({"matmul_precision": os.environ.get(precision.ENV)}
               if precision.PASSES is not None else {})}

    rows = {}
    # ---- CF reference rows (identical split) ----
    for arm, algo in CF_ARMS:
        if wanted(arm):
            t0 = time.time()
            m = cf_metrics(algo, data, dev)
            rows[arm] = emit(out_path, arm, m,
                             {"train_s": round(time.time() - t0, 1)}, log)

    # ---- PageRank control arms, scored from their top-1000 lists ----
    for arm, copies in PPR_ARMS:
        if wanted(arm):
            t0 = time.time()
            knn = ppr_lists(ppr_arm_graph(data, copies), data.graph.n_items)
            m = knn_list_metrics(knn, data.test_pos)
            rows[arm] = emit(out_path, arm, m,
                             {"train_s": round(time.time() - t0, 1),
                              "evaluator": "knn_list"}, log)

    for arm, overrides in ARMS:
        name = f"{arm}_s{seed}" if seed else arm
        if not wanted(arm, name):
            continue
        if seed:
            overrides = {**overrides, "train.seed": seed}
        log(f"=== arm {name} {overrides}")
        cfg = arm_config(name, overrides, args.quick)
        t0 = time.time()
        trainer = pinsage_trainer(data, cfg, work)
        t_pre = time.time() - t0
        t0 = time.time()
        trainer.train()
        t_train = time.time() - t0
        t0 = time.time()
        m = score(trainer.embed(), data.test_pos, dev)
        rows[name] = emit(out_path, name, m, {
            "precompute_s": round(t_pre, 1), "train_s": round(t_train, 1),
            "embed_eval_s": round(time.time() - t0, 1),
            "overrides": overrides, **tags}, log)
    return rows


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    return run(parse_args(argv), log)


if __name__ == "__main__":
    main()
