"""The walk-head + embedding-tail hybrid at dataset_large scale.

The port's counterpart of ``scripts/hybrid_1m_check.py``, without JAX.
It resumes the finished ``scale_demo`` co-listen run of the work dir
(``--hard --colisten-copies 1 --T 10``: run
``scale_demo_m0.1_lr0.001_co1_T10``) for its embeddings, then for every
unique test query builds three ranked lists of ``--k`` ids:

* embedding: streamed cosine top-k over the unit rows
  (``ops.knn.cosine_topk_streamed``, query blocks of 4096);
* walk: top-k PPR visits of 1000-hop restart walks (alpha 0.85) over the
  same co-listen augmented graph the trainer swept (K1, query blocks of
  4096);
* hybrid: the walk head merged with the embedding tail on the device
  (``ops.merge.merge_topk``, blocks of 8192),

and scores each on the test pairs: hit@10/100/500, mrr@1000, catalog
coverage@500, inter-diversity@100 and the low-degree (in-degree <= 1)
queries' hit@100 and mrr@1000::

    python -m gcn_song_embeddings_tpu_torch.hybrid_1m --work-dir DIR \\
        [--k 1000] [--out FILE] [--device cpu]

Prints the rows as one JSON line and writes them, with the counts and the
merge wall, to ``--out`` (default ``<work-dir>/hybrid_1m.json``).  Runs
on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch import scale_demo
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.ops.knn import cosine_topk_streamed
from gcn_song_embeddings_tpu_torch.ops.merge import merge_topk
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    block_generator,
    sample_neighborhood_topt_tables,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    draw_uniforms,
    fused_walk_tables,
)
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

# the scale_demo run this reads: margin 0.1, lr 1e-3, 3 x 500, co-listen 1,
# T 10, 8192 walkers a sweep block
CAPSTONE_RUN = ("--hard", "--colisten-copies", "1", "--T", "10")
EMB_BLOCK, WALK_BLOCK, MERGE_BLOCK = 4096, 4096, 8192
WALK_HOPS, WALK_ALPHA = 1000, 0.85


class HybridRun(NamedTuple):
    """The printed rows and the written result, the phase walls, the
    queries, their walk lists (weights, ids), and the resumed trainer
    (its ``graph`` is the augmented graph the walk lists walked)."""
    rows: dict
    result: dict
    walls: dict
    queries: np.ndarray
    walk: tuple
    trainer: PinSageTrainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", default=scale_demo.CAPSTONE_WORK_DIR)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--out", default=None,
                    help="JSON file (default: <work-dir>/hybrid_1m.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def score_lists(lists: np.ndarray, pairs: np.ndarray, n_items: int,
                low_sel: np.ndarray) -> dict:
    """One row of the table: ``lists`` [n_queries, k] ranked ids, ``pairs``
    [n, 2] (row of ``lists``, positive id), ``low_sel`` [n] the pairs of
    low-degree queries.  Coverage counts the ids in columns 1:501 (the
    reference's 1:K+1 quirk) over the catalog, not over the rows."""
    low = bool(low_sel.any())
    return {
        **{f"hit@{K}": round(M.hit_rate(lists, pairs, K), 5)
           for K in (10, 100, 500)},
        "mrr@1000": round(M.mrr(lists, pairs, 1000), 5),
        "coverage@500": round(float(
            np.unique(lists[:, 1:501]).shape[0] / n_items), 5),
        "inter_div@100": round(M.inter_diversity(lists, K=100), 5),
        "low_deg_mrr@1000": round(M.mrr(lists, pairs[low_sel], 1000), 5)
        if low else None,
        "low_deg_hit@100": round(M.hit_rate(lists, pairs[low_sel], 100), 5)
        if low else None,
    }


def padded_block(queries: np.ndarray, start: int, size: int) -> np.ndarray:
    """``queries[start:start + size]`` padded to ``size`` with its last
    query."""
    stop = min(start + size, len(queries))
    block = np.full((size,), queries[stop - 1], np.int32)
    block[:stop - start] = queries[start:stop]
    return block


def resume(args: argparse.Namespace, data: scale_demo.Dataset,
           log=print) -> PinSageTrainer:
    """The finished capstone run of the work dir, resumed; an unfinished
    or missing one is refused."""
    cfg = scale_demo.demo_config(scale_demo.parse_args(list(CAPSTONE_RUN)))
    runs = os.path.join(args.work_dir, "runs")
    state = os.path.join(runs, cfg.run_name, "state.npz")
    if not os.path.isfile(state):
        raise SystemExit(f"no {state}: run scale_demo "
                         f"{' '.join(CAPSTONE_RUN)} on this work dir first")
    tr = PinSageTrainer(
        data.dg, data.graph.n_items, data.graph.features, data.train_pos,
        cfg=cfg, base_run_dir=runs,
        nbhds_path=os.path.join(args.work_dir, "ds", "neighborhoods.npz"),
        log=False, load_save=True, verbose=True)
    if tr.e < cfg.train.epochs:
        raise SystemExit(f"{state} holds an unfinished run (epoch {tr.e} "
                         f"of {cfg.train.epochs}): finish it with "
                         f"scale_demo first")
    return tr


def run(args: argparse.Namespace, data: scale_demo.Dataset | None = None,
        log=print, query_sample: int | None = None) -> HybridRun:
    """Resume and embed, the three lists of every unique test query (each
    block drained to the host as it finishes), then the scores.  With
    ``query_sample``, the lists of that many unique test queries drawn
    from ``default_rng(0)``, scored on every test pair of theirs."""
    dev = resolve_device(args.device)
    log("device:", scale_demo.platform(dev))
    if data is None:
        data = scale_demo.load_dataset(os.path.join(args.work_dir, "ds"),
                                       dev)
    g, test_pos = data.graph, data.test_pos
    log(f"graph: {g.n_items} tracks, {len(test_pos)} test pairs")
    walls = {}
    t0 = time.time()
    tr = resume(args, data, log)
    emb = tr.embed()
    walls["resume_embed_s"] = time.time() - t0
    log(f"resume+embed: {walls['resume_embed_s']:.1f}s")

    queries = np.unique(test_pos[:, 0]).astype(np.int32)
    if query_sample is not None and query_sample < len(queries):
        queries = np.sort(np.random.default_rng(0).choice(
            queries, query_sample, replace=False))
        test_pos = test_pos[np.isin(test_pos[:, 0], queries)]
    nq, k = len(queries), args.k
    log(f"{nq} unique test queries, k={k}")

    # embedding lists: the streamed cosine top-k over the catalog; the
    # queries are rows of the table, slot 0 (the self) is dropped
    t0 = time.time()
    unit = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True),
                            1e-12)
    unit_dev = torch.as_tensor(unit, device=dev)
    emb_n = np.empty((nq, k), np.int32)
    emb_w = np.empty((nq, k), np.float32)
    for s in range(0, nq, EMB_BLOCK):
        e = min(s + EMB_BLOCK, nq)
        w, n = cosine_topk_streamed(unit_dev, torch.as_tensor(
            padded_block(queries, s, EMB_BLOCK), device=dev), k)
        emb_w[s:e] = w[:e - s].cpu().numpy()
        emb_n[s:e] = n[:e - s].cpu().numpy()
    del unit_dev
    walls["embedding_lists_s"] = time.time() - t0
    log(f"embedding lists: {walls['embedding_lists_s']:.1f}s")

    # walk lists over the augmented graph the trainer swept
    t0 = time.time()
    tables = fused_walk_tables(tr.graph)
    walk_n = np.empty((nq, k), np.int32)
    walk_w = np.empty((nq, k), np.float32)
    for s in range(0, nq, WALK_BLOCK):
        e = min(s + WALK_BLOCK, nq)
        w, n = sample_neighborhood_topt_tables(
            tables, torch.as_tensor(padded_block(queries, s, WALK_BLOCK),
                                    device=dev),
            WALK_HOPS, WALK_ALPHA, k, draw_uniforms(
                WALK_HOPS, WALK_BLOCK, block_generator(0, s, dev)))
        walk_w[s:e] = w[:e - s].cpu().numpy()
        walk_n[s:e] = n[:e - s].cpu().numpy()
    del tables
    walls["walk_lists_s"] = time.time() - t0
    log(f"walk lists: {walls['walk_lists_s']:.1f}s")

    # the merge on the device, over blocks of query rows (the tail padded
    # with weight 1.0)
    t0 = time.time()
    hyb_n = np.empty((nq, k), np.int32)
    for s in range(0, nq, MERGE_BLOCK):
        e = min(s + MERGE_BLOCK, nq)
        pad = ((0, MERGE_BLOCK - (e - s)), (0, 0))

        def put(a, value=0):
            return torch.as_tensor(np.pad(a[s:e], pad, constant_values=value),
                                   device=dev)

        _, n = merge_topk(put(walk_w), put(walk_n), put(emb_w, 1.0),
                          put(emb_n))
        hyb_n[s:e] = n[:e - s].cpu().numpy()
    merge_s = time.time() - t0
    walls["merge_s"] = merge_s
    log(f"device merge: {merge_s:.1f}s")

    # score the test pairs through the per-query lists
    t0 = time.time()
    pairs = np.stack([np.searchsorted(queries, test_pos[:, 0]),
                      test_pos[:, 1]], axis=1)
    low_sel = g.in_degrees()[test_pos[:, 0]] <= 1
    rows = {}
    for name, lists in (("walk", walk_n), ("embedding", emb_n),
                        ("hybrid", hyb_n)):
        rows[name] = score_lists(lists, pairs, g.n_items, low_sel)
        log(name, json.dumps(rows[name]))
    walls["score_s"] = time.time() - t0
    result = {"n_tracks": g.n_items, "n_test_pairs": int(len(test_pos)),
              "n_low_degree_pairs": int(low_sel.sum()),
              "merge_s": round(merge_s, 1), "rows": rows,
              "platform": scale_demo.platform(dev)}
    return HybridRun(rows, result, walls, queries, (walk_w, walk_n), tr)


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    args = parse_args(argv)
    hr = run(args, log=log)
    out = args.out or os.path.join(args.work_dir, "hybrid_1m.json")
    with open(out, "w") as f:
        json.dump(hr.result, f, indent=2)
    print(json.dumps(hr.rows))
    return hr.rows


if __name__ == "__main__":
    main()
