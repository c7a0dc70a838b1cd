"""int8 serving quality against f32 on the hard benchmark.

The port's counterpart of ``scripts/serve_int8_quality.py``, without JAX:
train PinSage on the hard dataset (``data.synth.ensure_hard_dataset``) at
margin 0.1 and at margin 1e-5 (lr 1e-3, 10 epochs, the same dataset and
split), then rank every test pair (a) under f32 cosine
(``evals.device_eval.rank_eval``) and (b) under the exact int8 scoring of
the serving index (``int8_rank_eval``: ``ops.quantize.quantize_rows`` and
``int8_scores``, the functions ``serve.py``'s int8 index calls), and
write the paired metrics with the relative drops of hit@100 and MRR::

    python -m gcn_song_embeddings_tpu_torch.serve_int8_quality \\
        [--work-dir build/serve_int8_work] [--out build/serve_int8.json] \\
        [--epochs 10] [--device cpu]

The work directory keeps the dataset, its PPR cache and the trained runs,
so a rerun reuses them.  Runs on the GPU unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.data.synth import ensure_hard_dataset
from gcn_song_embeddings_tpu_torch.evals.device_eval import (
    rank_eval,
    unit_rows,
)
from gcn_song_embeddings_tpu_torch.ops.quantize import (
    int8_scores,
    pad_table,
    quantize_rows,
)
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

# (row name, margin, lr) of the two rows, as the JAX script trains them
MARGINS = (("margin_0.1", 0.1, 1e-3), ("margin_1e-5", 1e-5, 1e-3))
HIT_KS, MRR_K = (10, 100, 500), 1000


def int8_pair_ranks(values: torch.Tensor, scales: torch.Tensor,
                    unit: torch.Tensor, q: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """1-based average rank [B] f32 of ``pos`` among the other items of
    ``q`` under the int8 scores of ``q``'s unit row against the table
    (``values``, ``scales``, padded by ``pad_table``; ``unit`` holds the
    catalog's N rows).  The query's own column scores -inf; ``pos`` is
    read from the same score matrix, so exact equality is the tie
    predicate (int8 scores are discrete), each tie counting half."""
    n = unit.shape[0]
    q, pos = q.long(), pos.long()
    sims = int8_scores(values, scales, unit[q])[:, :n]
    rows = torch.arange(q.shape[0], device=unit.device)
    sims[rows, q] = -torch.inf
    pos_sim = sims[rows, pos][:, None]
    better = (sims > pos_sim).sum(dim=1)
    tied = (sims == pos_sim).sum(dim=1) - 1        # minus pos itself
    return 1.0 + better.float() + tied.float() * 0.5


def int8_rank_eval(embeddings, test_pairs: np.ndarray,
                   hit_ks: tuple[int, ...] = HIT_KS, mrr_k: int = MRR_K,
                   batch: int = 2048, device=None) -> dict[str, float]:
    """hit@K and MRR@mrr_k of (query, positive) pairs under the serving
    index's int8 scoring: the unit-row table quantized once
    (``quantize_rows``), each query row scored by ``int8_scores``, the
    self column excluded and ties at the average rank (as
    ``rank_eval``), MRR capped at ``mrr_k`` (a miss counts as rank
    ``mrr_k``).  On ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    unit = torch.as_tensor(unit_rows(embeddings), device=dev)
    values, scales = pad_table(*quantize_rows(unit))
    pairs = torch.as_tensor(np.asarray(test_pairs, dtype=np.int64),
                            device=dev).reshape(-1, 2)
    ranks = np.concatenate([np.empty(0)] + [
        int8_pair_ranks(values, scales, unit, pairs[s:s + batch, 0],
                        pairs[s:s + batch, 1]).cpu().numpy()
        .astype(np.float64)
        for s in range(0, pairs.shape[0], batch)])
    out = {f"hit@{k}": float((ranks <= k).mean()) for k in hit_ks}
    out[f"mrr@{mrr_k}"] = float((1.0 / np.minimum(ranks, mrr_k)).mean())
    return out


def quality_row(emb: np.ndarray, test_pairs: np.ndarray,
                device=None) -> dict:
    """One row of the artifact: f32 and int8 metrics of ``emb`` and the
    relative drops of hit@100 and MRR under int8."""
    f32 = rank_eval(emb, test_pairs, hit_ks=HIT_KS, mrr_k=MRR_K,
                    batch=4096, device=device)
    i8 = int8_rank_eval(emb, test_pairs, device=device)
    return {
        "f32": {k: round(v, 5) for k, v in f32.items()},
        "int8": {k: round(v, 5) for k, v in i8.items()},
        "hit100_rel_drop": round(
            1 - i8["hit@100"] / max(f32["hit@100"], 1e-12), 4),
        "mrr_rel_drop": round(
            1 - i8[f"mrr@{MRR_K}"] / max(f32[f"mrr@{MRR_K}"], 1e-12), 4),
    }


def margin_config(name: str, margin: float, lr: float, epochs: int,
                  batches_per_epoch: int = 500) -> RunConfig:
    """A row's training config: the JAX script's overrides on
    ``RunConfig()`` (B=128, seed 0; the JAX script keeps the default 500
    batches an epoch)."""
    return config_with_overrides(RunConfig(run_name=f"int8q_{name}"), {
        "train.epochs": epochs, "train.batches_per_epoch": batches_per_epoch,
        "train.margin": margin, "train.lr": lr, "walk.batch_walkers": 8192})


def train_embed(dg: DeviceGraph, graph: SongGraph, train_pos: np.ndarray,
                cfg: RunConfig, work_dir: str, ds_path: str,
                verbose: bool = True) -> np.ndarray:
    """Train (resuming ``<work_dir>/runs/<run_name>``) and embed every
    track."""
    tr = PinSageTrainer(dg, graph.n_items, graph.features, train_pos,
                        cfg=cfg, base_run_dir=os.path.join(work_dir, "runs"),
                        nbhds_path=os.path.join(ds_path,
                                                "neighborhoods.npz"),
                        log=False, load_save=True, verbose=verbose)
    tr.train()
    return tr.embed()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", default="build/serve_int8_work")
    ap.add_argument("--tracks", type=int, default=20_000)
    ap.add_argument("--collections", type=int, default=4_000)
    ap.add_argument("--positives", type=int, default=60_000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--out", default="build/serve_int8.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    dev = resolve_device(args.device)
    log("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else dev)
    ds_path = ensure_hard_dataset(
        os.path.join(args.work_dir, "ds"), n_tracks=args.tracks,
        n_collections=args.collections, n_positives=args.positives,
        seed=0, log=log)
    g = SongGraph(ds_path,
                  features_file=os.path.join(ds_path, "features.npy"))
    dg = DeviceGraph.from_graph(g, dev)
    train_pos, test_pos = g.load_positives_split(
        os.path.join(ds_path, "positives.json"))

    rows = {}
    for name, margin, lr in MARGINS:
        t0 = time.time()
        emb = train_embed(dg, g, train_pos,
                          margin_config(name, margin, lr, args.epochs),
                          args.work_dir, ds_path)
        log(f"{name}: trained+embedded in {time.time() - t0:.1f}s")
        rows[name] = quality_row(emb, test_pos, dev)
        log(name, json.dumps(rows[name]))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"dataset": {"tracks": g.n_items,
                               "test_pairs": int(len(test_pos)),
                               "kind": "hard", "epochs": args.epochs},
                   "rows": rows}, f, indent=2)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
