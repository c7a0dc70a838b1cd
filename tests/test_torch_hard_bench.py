"""The port's hard benchmark and int8 serving-quality modules, on the CPU.

``serve_int8_quality.int8_rank_eval`` equals the JAX script's
(``scripts/serve_int8_quality.py``, loaded from its path) on a seeded
embedding whose duplicated rows force ties: the int8 scores are bit-equal
(``tests/test_torch_quantize.py``), so hit@K is exact and MRR within
1e-12 (the same float64 mean of the same ranks).  A tiny
``hard_bench.main`` run prints a summary with the JAX script's keys, its
ratios computed from its own rows.
"""

import ast
import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch import hard_bench, serve_int8_quality
from gcn_song_embeddings_tpu_torch.evals.device_eval import unit_rows
from gcn_song_embeddings_tpu_torch.ops.quantize import (
    pad_table,
    quantize_rows,
)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
MRR_ATOL = 1e-12


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tie_heavy(seed=0, n=600, d=32, dup=40):
    """A seeded [n, d] table whose rows repeat in groups (exact ties under
    any scoring), with pairs whose queries and positives hit them."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n // 2, d)).astype(np.float32)
    emb = np.concatenate([base, base[rng.integers(0, dup, n - n // 2)]])
    pairs = rng.integers(0, n, (700, 2)).astype(np.int32)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    # positives that duplicate their query's row, and queries among twins
    twins = np.stack([np.arange(n // 2, n // 2 + 50),
                      np.arange(n // 2 + 50, n // 2 + 100)], axis=1)
    return emb, np.concatenate([pairs, twins.astype(np.int32)])


@pytest.mark.parametrize("batch", [64, 2048])
def test_int8_rank_eval_equals_jax_on_ties(batch):
    emb, pairs = _tie_heavy()
    kw = dict(hit_ks=(1, 10, 100, 500), mrr_k=100, batch=batch)
    got = serve_int8_quality.int8_rank_eval(emb, pairs, device="cpu", **kw)
    want = _jax_script("serve_int8_quality").int8_rank_eval(emb, pairs, **kw)
    assert got.keys() == want.keys()
    for key in want:
        if key.startswith("hit@"):
            assert got[key] == want[key], (key, got, want)
        else:
            assert abs(got[key] - want[key]) <= MRR_ATOL, (key, got, want)
    # the ties are real: a quarter of the pairs rank at a half
    unit = torch.as_tensor(unit_rows(emb))
    values, scales = pad_table(*quantize_rows(unit))
    q, pos = torch.as_tensor(pairs).long().unbind(dim=1)
    ranks = serve_int8_quality.int8_pair_ranks(values, scales, unit, q, pos)
    assert (ranks % 1 == 0.5).float().mean() > 0.2


def test_int8_rank_eval_counts_ties_at_the_average_rank():
    # q=0: rows 1 and 2 equal the positive's row 3 (three tied, pos
    # included), row 4 scores above them: rank 1 + 1 + 2/2 = 3
    emb = np.array([[1, 0], [0.6, 0.8], [0.6, 0.8], [0.6, 0.8],
                    [0.9, 0.1], [-1, 0]], np.float32)
    got = serve_int8_quality.int8_rank_eval(emb, [[0, 3]], hit_ks=(2, 3),
                                            mrr_k=10, device="cpu")
    assert got == {"hit@2": 0.0, "hit@3": 1.0, "mrr@10": 1 / 3}


def _jax_summary_keys():
    """The top-level keys of the JAX script's ``summary`` dict."""
    with open(os.path.join(SCRIPTS, "hard_bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["summary"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in scripts/hard_bench.py")


def test_hard_bench_main_prints_the_jax_summary(tmp_path, capsys):
    work = str(tmp_path / "hb")
    summary = hard_bench.main([
        "--tracks", "1000", "--collections", "200", "--positives", "3000",
        "--feature-dim", "16", "--epochs", "1", "--batches-per-epoch", "10",
        "--work-dir", work, "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == summary
    assert set(summary) == _jax_summary_keys()
    assert set(summary["times_s"]) == {"synth", "load_graph",
                                       "features_eval", "precompute",
                                       "train", "embed", "eval"}
    assert summary["n_tracks"] == 1000 and summary["work_dir"] == work
    keys = {"hit@10", "hit@100", "hit@500", "mrr@1000"}
    assert set(summary["features"]) == set(summary["pinsage"]) == keys
    for ratio, key in (("pinsage_over_features_hit100", "hit@100"),
                       ("pinsage_over_features_mrr", "mrr@1000")):
        want = summary["pinsage"][key] / summary["features"][key]
        # the ratio is of the unrounded metrics; the rows hold 5 decimals
        assert summary[ratio] == pytest.approx(want, rel=1e-3, abs=2e-3)
    # a rerun reuses the dataset and resumes the finished run
    again = hard_bench.main(["--tracks", "1000", "--epochs", "1",
                             "--batches-per-epoch", "10", "--feature-dim",
                             "16", "--work-dir", work, "--device", "cpu"])
    assert again["pinsage"] == summary["pinsage"]


def test_hard_bench_train_seed_trains_a_run_of_its_own(tmp_path, capsys):
    argv = ["--tracks", "1000", "--collections", "200", "--positives",
            "3000", "--feature-dim", "16", "--epochs", "1",
            "--batches-per-epoch", "10", "--work-dir", str(tmp_path / "hb"),
            "--device", "cpu"]
    default = hard_bench.main(argv)
    other = hard_bench.main([*argv, "--train-seed", "1"])
    capsys.readouterr()
    assert "train_seed" not in default["config"]
    assert other["config"]["train_seed"] == 1
    assert sorted(os.listdir(tmp_path / "hb" / "runs")) == [
        "hard_m0.1_lr0.001", "hard_m0.1_lr0.001_s1"]
    # the same dataset, so the same features row; another model
    assert other["features"] == default["features"]
    assert other["pinsage"] != default["pinsage"]


def test_serve_int8_quality_main_writes_both_rows(tmp_path, capsys,
                                                  monkeypatch):
    # 10 batches an epoch, not the JAX script's 500, to stay small
    monkeypatch.setattr(serve_int8_quality, "margin_config", functools.partial(
        serve_int8_quality.margin_config, batches_per_epoch=10))
    out = tmp_path / "out" / "serve_int8.json"
    rows = serve_int8_quality.main([
        "--work-dir", str(tmp_path / "work"), "--tracks", "1000",
        "--collections", "200", "--positives", "3000", "--epochs", "1",
        "--out", str(out), "--device", "cpu"])
    # the trainers' progress lines come first, the rows last
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rows
    with open(out) as f:
        written = json.load(f)
    assert written["rows"] == rows
    assert written["dataset"]["kind"] == "hard"
    assert written["dataset"]["tracks"] == 1000
    assert list(rows) == ["margin_0.1", "margin_1e-5"]
    for row in rows.values():
        assert set(row) == {"f32", "int8", "hit100_rel_drop",
                            "mrr_rel_drop"}
        assert set(row["f32"]) == set(row["int8"]) == {
            "hit@10", "hit@100", "hit@500", "mrr@1000"}
        assert row["hit100_rel_drop"] == pytest.approx(
            1 - row["int8"]["hit@100"] / row["f32"]["hit@100"], abs=1e-3)
