"""Hyperparameter grid search (own copy of
gcn_song_embeddings_tpu/train/grid_search.py).

A ``{dotted.param: [values]}`` grid: every point is trained by the port's
``PinSageTrainer`` under ``<base_run_dir>/gridsearch#<i.j...>-<hash>``
(resuming a run of the same values), embedded, and scored by MRR and
hit rate at 100 of its kNN lists; the results, sorted by MRR, go to a
JSON file.
"""

from __future__ import annotations

import hashlib
import itertools
import json
from typing import Any

import numpy as np

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


def get_param_sets(grid: dict[str, list[Any]]
                   ) -> list[tuple[str, dict[str, Any]]]:
    """The cartesian product, with run ids "i.j.k..." of value indices."""
    keys = list(grid.keys())
    out = []
    for combo in itertools.product(*(range(len(grid[k])) for k in keys)):
        run_id = ".".join(str(i) for i in combo)
        params = {k: grid[k][i] for k, i in zip(keys, combo)}
        out.append((run_id, params))
    return out


def grid_search(graph, train_pos: np.ndarray, test_pos: np.ndarray,
                grid: dict[str, list[Any]],
                base_cfg: RunConfig | None = None,
                base_run_dir: str = "./runs_gs",
                out_path: str | None = "grid_search.json",
                eval_k: int = 1000, verbose: bool = True,
                device=None) -> list[dict]:
    """Train and evaluate every grid point on ``device`` (default: the
    GPU); returns the results sorted by MRR, best first."""
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer

    dev = resolve_device(device)
    base_cfg = base_cfg or RunConfig()
    device_graph = DeviceGraph.from_graph(graph, dev)
    results = []
    nbhds_path = getattr(graph, "nbhds_path", None)

    for run_id, params in get_param_sets(grid):
        # the value hash keeps a run dir from resuming a checkpoint
        # trained under other values of the same grid index
        tag = hashlib.sha1(
            json.dumps(params, sort_keys=True).encode()).hexdigest()[:8]
        run_name = f"gridsearch#{run_id}-{tag}"
        cfg = config_with_overrides(base_cfg, params).replace(
            run_name=run_name)
        if verbose:
            print(f"[grid] {run_name}: {params}")
        trainer = PinSageTrainer(
            device_graph, graph.n_items, graph.features, train_pos,
            cfg=cfg, base_run_dir=base_run_dir, nbhds_path=nbhds_path,
            log=False, load_save=True, verbose=verbose)
        trainer.train()
        k = min(eval_k, graph.n_items - 1)
        _, knn_n = knn_from_emb(trainer.embed(), k=k, device=dev)
        res = {
            "id": run_id,
            "params": params,
            "mrr": M.mrr(knn_n, test_pos, k),
            "hit_rate": M.hit_rate(knn_n, test_pos, min(100, k)),
        }
        results.append(res)
        if verbose:
            print(f"[grid] {run_name}: mrr={res['mrr']:.5f} "
                  f"hr@100={res['hit_rate']:.5f}")

    results.sort(key=lambda r: r["mrr"], reverse=True)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2)
    return results
