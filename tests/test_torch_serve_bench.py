"""The port's ``serve_bench`` against ``scripts/serve_bench.py``, on the CPU.

The synthetic bipartite graph of ``--hybrid`` equals the JAX script's
recipe (``default_rng(0)`` after the catalog's rows, through the JAX
package's ``_build_csr``) array for array, and leaves the generator where
the recipe does; ``pct`` is the JAX script's.  ``main`` on the CPU prints
the JAX script's keys for the embedding index in f32 and int8, the
live-walk and cached-head hybrid and ``--adds``; every answer holds k
neighbours without the query (the f32 ones the exact top-k of the
catalog); ``--adds`` with ``--hybrid`` is refused.
"""

import json

import numpy as np
import pytest

from gcn_song_embeddings_tpu.data.graph import _build_csr as j_build_csr
from gcn_song_embeddings_tpu_torch import serve_bench
from torch_capstone import assigned_dict, dict_keys, jax_script, script_tree
from torch_threads import one_torch_thread  # noqa: F401

SMALL = ["--tracks", "1200", "--queries", "6", "--clients", "3",
         "--batch", "8", "--hops", "60", "--device", "cpu"]


def _jax_recipe(tracks, dim):
    """scripts/serve_bench.py:83-106, on the host."""
    rng = np.random.default_rng(0)
    rng.normal(size=(tracks, dim)).astype(np.float32)
    n_cols = max(tracks // 4, 1)
    deg = 8
    src = np.repeat(np.arange(tracks, dtype=np.int64), deg)
    dst = rng.integers(0, n_cols, size=src.size)
    i2c = j_build_csr(src, dst, tracks)
    c2i = j_build_csr(dst, src, n_cols)
    pairs = rng.integers(0, tracks, size=(tracks // 2, 2)).astype(np.int64)
    return i2c, c2i, pairs, rng


@pytest.mark.parametrize("tracks", [7, 1000])
def test_synthetic_graph_equals_the_jax_recipe(tracks):
    i2c, c2i, pairs, rng_after = _jax_recipe(tracks, 16)
    rng = np.random.default_rng(0)
    rng.normal(size=(tracks, 16)).astype(np.float32)
    dg, got_pairs = serve_bench.synthetic_graph(tracks, rng, "cpu")
    for got, want in ((dg.i2c_indptr, i2c.indptr),
                      (dg.i2c_indices, i2c.indices),
                      (dg.c2i_indptr, c2i.indptr),
                      (dg.c2i_indices, c2i.indices)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_pairs, pairs)
    assert got_pairs.dtype == np.int64
    assert rng.integers(0, 1 << 30) == rng_after.integers(0, 1 << 30)


def test_pct_equals_the_jax_scripts():
    pct = jax_script("serve_bench").pct
    rng = np.random.default_rng(2)
    for n in (1, 2, 7, 50, 400):
        xs = list(rng.random(n))
        for p in (0, 50, 99, 100):
            assert serve_bench.pct(xs, p) == pct(xs, p)


def _jax_keys():
    tree = script_tree("serve_bench")
    final = next(n for n in ast_calls(tree, "print")
                 if "sequential" in dict_keys(n))
    return (dict_keys(final),
            {name: dict_keys(assigned_dict(tree, name))
             for name in ("seq", "conc", "bat", "adds")})


def ast_calls(tree, func):
    """The dict arguments of ``func(json.dumps({...}))`` calls."""
    import ast

    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == func and node.args
                and isinstance(node.args[0], ast.Call)
                and node.args[0].args
                and isinstance(node.args[0].args[0], ast.Dict)):
            yield node.args[0].args[0]


@pytest.mark.parametrize("extra", [[], ["--int8"], ["--hybrid"],
                                   ["--hybrid", "--cached-head"],
                                   ["--adds", "2"]],
                         ids=["f32", "int8", "live_walk", "cached_head",
                              "adds"])
def test_main_prints_the_jax_keys(extra, capsys):
    summary = serve_bench.main([*SMALL, *extra])
    assert json.loads(capsys.readouterr().out) == summary
    top, nested = _jax_keys()
    hybrid = "--hybrid" in extra
    want = top - ({"hops", "chains", "cached_head"} if not hybrid else set())
    want -= set() if "--adds" in extra else {"online_adds"}
    assert set(summary) == want
    for key, name in (("sequential", "seq"), ("concurrent", "conc"),
                      ("batched", "bat")):
        assert set(summary[key]) == nested[name]
    if "--adds" in extra:
        assert set(summary["online_adds"]) == nested["adds"]
        assert summary["online_adds"]["batches"] == 2
    assert summary["platform"] == "cpu" and summary["int8"] == (
        "--int8" in extra)
    assert summary["concurrent"]["total_queries"] == 18
    if hybrid:
        assert summary["cached_head"] == ("--cached-head" in extra)


def test_answers_are_the_exact_top_k():
    run = serve_bench.run(serve_bench.parse_args(SMALL), log=lambda *a: None)
    unit = run.emb / np.linalg.norm(run.emb, axis=1, keepdims=True)
    assert len(run.answers) >= 6
    for row, (ids, scores) in run.answers.items():
        sims = unit @ unit[row]
        sims[row] = -np.inf
        want = np.sort(sims)[::-1][:serve_bench.K]
        np.testing.assert_allclose(np.sort(sims[ids])[::-1], want,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(scores, sims[ids], rtol=0, atol=1e-5)
    assert run.table_bytes == 1200 * 128 * 4


def test_check_answer_refuses_short_repeated_or_self_lists():
    good = [{"index": i, "score": 1.0 - i / 10} for i in range(1, 11)]
    assert serve_bench.check_answer(good, 0)[0] == list(range(1, 11))
    for bad, row in ((good[:9], 0), (good[:9] + good[:1], 0), (good, 3)):
        with pytest.raises(RuntimeError, match="bad answer"):
            serve_bench.check_answer(bad, row)


def test_adds_with_hybrid_is_refused():
    with pytest.raises(SystemExit, match="--adds"):
        serve_bench.main([*SMALL, "--hybrid", "--adds", "2"])
