"""Incremental PPR refresh at dataset_large scale.

The port's counterpart of ``scripts/refresh_1m_check.py``, without JAX.
A catalog with a standing co-listen augmented neighborhoods artifact
(the work dir of ``scale_demo --colisten-copies 1``, whose trainer
swept it as ``ds/neighborhoods.colisten1.npz``) receives a trickle of
new co-listen pairs.  For batches of 100, 1,000 and 10,000 random pairs
(``default_rng(42)``, self-pairs dropped) it measures the affected
share of origins and the affected-scan wall, then ``refresh_neighborhoods``'
wall, then the full re-sweep of the last augmented graph, and the
distribution parity: the mean total-variation distance between refreshed
and fully re-swept rows of sampled affected origins, beside the seed
noise of a second sweep of the same origins::

    python -m gcn_song_embeddings_tpu_torch.refresh_1m --work-dir DIR \\
        [--pair-counts 100,1000,10000] [--out FILE] [--device cpu]

Prints one JSON line and writes it to ``--out`` (default
``<work-dir>/refresh_1m.json``).  Runs on the GPU unless ``--device``
names another device.
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

from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import augment_with_colisten
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    _neighborhood_sweep_nodeset,
    affected_origins,
    effective_chains,
    precompute_neighborhoods,
    refresh_neighborhoods,
    seeded_generator,
)
from gcn_song_embeddings_tpu_torch.ops.walks import fused_walk_tables
from gcn_song_embeddings_tpu_torch.scale_demo import (
    CAPSTONE_WORK_DIR,
    Dataset,
    load_dataset,
    platform,
)
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


class RefreshRun(NamedTuple):
    """The printed result, and what the result does not print: whether
    every unaffected row of each refresh equals the standing artifact,
    the standing artifact's load wall and whether it was found cached."""
    result: dict
    unaffected_equal: dict   # new pairs -> bool
    standing_s: float
    standing_cached: bool


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", default=CAPSTONE_WORK_DIR)
    ap.add_argument("--pair-counts", default="100,1000,10000")
    ap.add_argument("--parity-sample", type=int, default=512)
    ap.add_argument("--out", default=None,
                    help="JSON file (default: <work-dir>/refresh_1m.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def tv_rows(wa: np.ndarray, na: np.ndarray, wb: np.ndarray,
            nb: np.ndarray) -> np.ndarray:
    """Per-row total-variation distance between two top-T weight lists
    (zero-weight slots ignored)."""
    out = np.empty(wa.shape[0])
    for i in range(wa.shape[0]):
        d1 = {int(x): float(v) for x, v in zip(na[i], wa[i]) if v > 0}
        d2 = {int(x): float(v) for x, v in zip(nb[i], wb[i]) if v > 0}
        out[i] = 0.5 * sum(abs(d1.get(k, 0.0) - d2.get(k, 0.0))
                           for k in set(d1) | set(d2))
    return out


def run(args: argparse.Namespace, data: Dataset | None = None,
        log=print) -> RefreshRun:
    """The measurements, on ``data`` (default: loaded from
    ``<work-dir>/ds``), each wall on the host clock."""
    dev = resolve_device(args.device)
    log("device:", platform(dev))
    ds = os.path.join(args.work_dir, "ds")
    if data is None:
        data = load_dataset(ds, dev)
    dg, n_items = data.dg, data.dg.n_items
    cfg = WalkConfig(colisten_copies=1, batch_walkers=8192)

    # the standing augmented graph and its artifact: the trainer's sweep
    # of the same graph under the same walk settings, cached under this
    # name (apply_colisten_config's)
    base_aug = augment_with_colisten(dg, data.train_pos, 1)
    base_path = os.path.join(ds, "neighborhoods.colisten1.npz")
    cached = os.path.isfile(base_path)
    t0 = time.time()
    old_w, old_n = precompute_neighborhoods(base_aug, cfg, base_path,
                                            seed=0, verbose=True)
    standing_s = time.time() - t0
    log(f"standing artifact: {standing_s:.1f}s (cached={cached})")

    rng = np.random.default_rng(42)
    rows, unaffected_equal = [], {}
    for m in [int(x) for x in args.pair_counts.split(",")]:
        new_pairs = rng.integers(0, n_items, size=(m, 2)).astype(np.int64)
        new_pairs = new_pairs[new_pairs[:, 0] != new_pairs[:, 1]]
        # the incrementally augmented graph: the base + the new pairs
        aug2 = augment_with_colisten(base_aug, new_pairs, 1)
        t0 = time.time()
        aff = affected_origins(old_w, old_n, new_pairs, n_items)
        t_aff = time.time() - t0
        t0 = time.time()
        ref_w, ref_n = refresh_neighborhoods(
            aug2, cfg, old_w, old_n, new_pairs, path=None, seed=3,
            verbose=True)
        t_refresh = time.time() - t0
        row = {"new_pairs": int(m), "affected": int(len(aff)),
               "affected_frac": round(len(aff) / n_items, 5),
               "affect_scan_s": round(t_aff, 2),
               "refresh_s": round(t_refresh, 1)}
        log(json.dumps(row))
        rows.append(row)
        keep = np.ones(n_items, dtype=bool)
        keep[aff] = False
        unaffected_equal[m] = bool(
            np.array_equal(ref_w[keep], old_w[keep])
            and np.array_equal(ref_n[keep], old_n[keep]))
        # only the last iteration's arrays are kept (host memory at 1M)

    # the full re-sweep of the last (largest) augmented graph
    t0 = time.time()
    full_w, full_n = precompute_neighborhoods(aug2, cfg, None, seed=1,
                                              verbose=True)
    t_full = time.time() - t0
    log(f"full re-sweep: {t_full:.1f}s")

    # parity on sampled affected origins: TV(refresh, full) beside the
    # seed noise TV(a second sweep of the same origins, full)
    samp = rng.permutation(aff)[: args.parity_sample].astype(np.int32)
    w2, n2 = _neighborhood_sweep_nodeset(
        fused_walk_tables(aug2), torch.as_tensor(samp, device=dev),
        cfg.n_hops, cfg.alpha, cfg.t_precompute, seeded_generator([7], dev),
        cfg.batch_walkers, effective_chains(cfg.n_hops, cfg.parallel_chains))
    w2, n2 = w2.cpu().numpy(), n2.cpu().numpy()
    tv_refresh = float(tv_rows(ref_w[samp], ref_n[samp],
                               full_w[samp], full_n[samp]).mean())
    tv_noise = float(tv_rows(w2, n2, full_w[samp], full_n[samp]).mean())
    log(f"parity: TV(refresh, full)={tv_refresh:.4f} vs seed-noise "
        f"TV={tv_noise:.4f}")

    result = {
        "n_tracks": int(n_items),
        "rows": rows,
        "full_resweep_s": round(t_full, 1),
        "parity_sample": int(len(samp)),
        "tv_refresh_vs_full": round(tv_refresh, 5),
        "tv_seed_noise": round(tv_noise, 5),
        "platform": platform(dev),
    }
    return RefreshRun(result, unaffected_equal, standing_s, cached)


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    args = parse_args(argv)
    result = run(args, log=log).result
    out = args.out or os.path.join(args.work_dir, "refresh_1m.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
