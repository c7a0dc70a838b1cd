"""The port's grid search (``train/grid_search.py``) and CLI ``grid`` vs
the JAX package, on the CPU at a tiny size.

``get_param_sets`` must equal JAX's (ids and values); ``grid_search``
trains every point, names its run dirs ``gridsearch#<ids>-<value hash>``
as JAX does, sorts the results by MRR and writes them to JSON.
"""

from __future__ import annotations

import glob
import json
import os

import pytest

from gcn_song_embeddings_tpu.train.grid_search import (
    get_param_sets as j_get_param_sets,
)
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.train.grid_search import (
    get_param_sets,
    grid_search,
)
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"train.epochs": 1, "train.batches_per_epoch": 3,
        "train.batch_size": 8, "walk.n_hops": 40, "walk.t_precompute": 20,
        "walk.batch_walkers": 256, "model.hidden_dim": 16,
        "model.out_dim": 8}


@pytest.mark.parametrize("grid", [
    {"train.lr": [1e-3, 1e-4], "model.T": [2, 3]},
    {"a": [1], "b": ["x", "y", "z"], "c": [True, False]},
    {}])
def test_param_sets_equal_jax(grid):
    assert get_param_sets(grid) == j_get_param_sets(grid)


def _hashed_dirs(root):
    return sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(root, "gridsearch#*")))


def test_grid_search_trains_sorts_and_writes(dataset_dir, tmp_path):
    g = SongGraph(dataset_dir,
                  features_file=os.path.join(dataset_dir, "features.npy"))
    train, test = g.load_positives_split(
        os.path.join(dataset_dir, "positives.json"))
    out = str(tmp_path / "gs.json")
    runs = str(tmp_path / "runs_gs")
    grid = {"train.lr": [1e-3, 1e-5], "model.T": [2]}
    results = grid_search(g, train, test, grid,
                          base_cfg=config_with_overrides(RunConfig(), TINY),
                          base_run_dir=runs, out_path=out, eval_k=50,
                          verbose=False, device="cpu")
    assert [r["id"] for r in sorted(results, key=lambda r: r["id"])] == [
        "0.0", "1.0"]
    assert results[0]["mrr"] >= results[1]["mrr"]
    assert all(0.0 <= r["hit_rate"] <= 1.0 for r in results)
    with open(out) as f:
        assert json.load(f) == results
    dirs = _hashed_dirs(runs)
    assert len(dirs) == 2 and dirs[0].startswith("gridsearch#0.0-")
    # a rerun of the same grid resumes its runs: same dirs, same results
    again = grid_search(g, train, test, grid,
                        base_cfg=config_with_overrides(RunConfig(), TINY),
                        base_run_dir=runs, out_path=None, eval_k=50,
                        verbose=False, device="cpu")
    assert _hashed_dirs(runs) == dirs
    assert [r["mrr"] for r in again] == [r["mrr"] for r in results]


def test_cli_grid(dataset_dir, tmp_path, capsys):
    grid_path = tmp_path / "grid.json"
    grid_path.write_text(json.dumps({"train.lr": [1e-3]}))
    out = tmp_path / "grid_search.json"
    sets = [a for k, v in TINY.items() for a in ("--set", f"{k}={v}")]
    cli.main(["grid", "--dataset", dataset_dir, "--grid", str(grid_path),
              "--out", str(out), "--run-dir", str(tmp_path / "runs"),
              "--device", "cpu", *sets])
    results = json.loads(out.read_text())
    assert len(results) == 1 and results[0]["id"] == "0"
    assert results[0]["params"] == {"train.lr": 1e-3}
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex("\n[") + 1:]) == results
    assert _hashed_dirs(str(tmp_path / "runs"))[0].startswith(
        "gridsearch#0-")
