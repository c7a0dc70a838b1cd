"""The port's ``hybrid_1m`` against ``scripts/hybrid_1m_check.py``, on the
CPU.

``score_lists`` equals the JAX script's scoring arithmetic (its dict
expression, taken from the script and run through
``gcn_song_embeddings_tpu.evals.metrics``) on seeded lists with repeated
ids and tied ranks, with and without low-degree pairs.  On a tiny port
``scale_demo`` capstone work dir, ``main`` writes the three rows with the
JAX script's keys into the work dir (the hybrid at least the walk row on
hit@K: its head is the walk's weighted entries) and nothing under
``results/``; a missing or unfinished run is refused.
"""

import ast
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from gcn_song_embeddings_tpu.evals import metrics as JM
from gcn_song_embeddings_tpu_torch import hybrid_1m
from torch_capstone import REPO, capstone_work_dir, script_tree
from torch_threads import one_torch_thread  # noqa: F401


def _jax_scoring():
    """The dict the JAX script builds for each row (``out[name] = {...}``),
    as a function of its names."""
    tree = script_tree("hybrid_1m_check")
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and isinstance(n.targets[0], ast.Subscript)
                and n.targets[0].value.id == "out")
    fn = ast.parse("def score(lists, pairs, low_sel, g, M, np): pass").body[0]
    fn.body = [ast.Return(value=node.value)]
    scope = {}
    exec(compile(ast.fix_missing_locations(ast.Module(
        body=[fn], type_ignores=[])), "hybrid_1m_check", "exec"), scope)
    return scope["score"]


@pytest.mark.parametrize("low_degree", [True, False])
def test_score_lists_equals_the_jax_scripts_arithmetic(low_degree):
    rng = np.random.default_rng(5)
    n_items, nq, k = 3000, 400, 1000
    lists = rng.integers(0, n_items, (nq, k)).astype(np.int32)
    # repeated ids (a walk list's zero-weight tail repeats its last id),
    # a positive listed twice, and rows that tie on every rank
    lists[:50, 600:] = lists[:50, 599:600]
    lists[50:60] = lists[60:70]
    pairs = np.stack([rng.integers(0, nq, 900),
                      rng.integers(0, n_items, 900)], axis=1)
    pairs[:100, 1] = lists[pairs[:100, 0], rng.integers(0, 700, 100)]
    pairs[100:110] = pairs[:10]
    degrees = rng.integers(0, 6, 900)
    low_sel = degrees <= 1 if low_degree else np.zeros(900, bool)
    got = hybrid_1m.score_lists(lists, pairs, n_items, low_sel)
    want = _jax_scoring()(lists, pairs, low_sel,
                          SimpleNamespace(n_items=n_items), JM, np)
    assert got == want
    assert list(got) == list(want)
    assert (got["low_deg_mrr@1000"] is None) == (not low_degree)
    assert got["hit@500"] > 0.1


def test_padded_block_repeats_the_last_query():
    q = np.arange(10, 17, dtype=np.int32)
    np.testing.assert_array_equal(hybrid_1m.padded_block(q, 0, 4),
                                  [10, 11, 12, 13])
    np.testing.assert_array_equal(hybrid_1m.padded_block(q, 4, 4),
                                  [14, 15, 16, 16])


@pytest.fixture(scope="module")
def capstone(tmp_path_factory):
    return capstone_work_dir(str(tmp_path_factory.mktemp("capstone")))


def test_main_writes_three_rows(capstone, capsys):
    before = sorted(os.listdir(os.path.join(REPO, "results")))
    rows = hybrid_1m.main(["--work-dir", capstone, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rows
    assert list(rows) == ["walk", "embedding", "hybrid"]
    keys = set(_jax_scoring()(
        np.zeros((2, 600), np.int32), np.zeros((1, 2), np.int64),
        np.ones(1, bool), SimpleNamespace(n_items=2), JM, np))
    for row in rows.values():
        assert set(row) == keys
    for K in (10, 100, 500):
        assert rows["hybrid"][f"hit@{K}"] >= rows["walk"][f"hit@{K}"]
    with open(os.path.join(capstone, "hybrid_1m.json")) as f:
        written = json.load(f)
    assert written["rows"] == rows
    assert written["n_tracks"] == 2000 and written["platform"] == "cpu"
    assert {"n_test_pairs", "n_low_degree_pairs", "merge_s"} <= set(written)
    assert sorted(os.listdir(os.path.join(REPO, "results"))) == before


def test_run_returns_walk_lists_of_every_query(capstone):
    hr = hybrid_1m.run(hybrid_1m.parse_args(
        ["--work-dir", capstone, "--k", "50", "--device", "cpu"]),
        log=lambda *a: None)
    w, n = hr.walk
    assert w.shape == n.shape == (len(hr.queries), 50)
    assert (np.diff(w, axis=1) <= 0).all()          # ranked by weight
    assert not (n == hr.queries[:, None])[w > 0].any()   # never the query
    assert hr.trainer.e == 3
    assert set(hr.walls) == {"resume_embed_s", "embedding_lists_s",
                             "walk_lists_s", "merge_s", "score_s"}


def test_missing_or_unfinished_run_is_refused(capstone, tmp_path):
    work = str(tmp_path / "w")
    shutil.copytree(os.path.join(capstone, "ds"), os.path.join(work, "ds"))
    with pytest.raises(SystemExit, match="no .*state.npz"):
        hybrid_1m.main(["--work-dir", work, "--device", "cpu"])
    # one epoch of the capstone's three: the run is there but unfinished
    capstone_work_dir(work, "--epochs", "1")
    with pytest.raises(SystemExit, match="unfinished run"):
        hybrid_1m.main(["--work-dir", work, "--device", "cpu"])
