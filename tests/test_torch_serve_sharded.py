"""The port's catalog-sharded serving (``parallel/serve_sharded.py``,
``serve --sharded``) on gloo worlds of 2 and 4 processes on the CPU
(``torch_dist.run_world``, one spawn per world), against the port's
single-process ``EmbeddingIndex`` / ``HybridIndex`` and JAX's
``ShardedServeIndex`` on its virtual CPU mesh with the same graph axis.

Scores are the single-device indexes' (the same f32 products, the same
int8 math), so results are equal up to ties: the scores at every rank
position, and the ids of every run of tied scores that ends inside the
top k, as a set (``torch_dist.same_up_to_ties``).
"""

import os

import jax
import numpy as np
import pytest

from gcn_song_embeddings_tpu.parallel.mesh import make_mesh as j_make_mesh
from gcn_song_embeddings_tpu.parallel.serve_sharded import (
    ShardedServeIndex as JShardedServeIndex,
)
from gcn_song_embeddings_tpu_torch import serve as ts
from torch_dist import run_world
from torch_dist import same_up_to_ties as _same_up_to_ties
from torch_threads import one_torch_thread  # noqa: F401

K, K_CAP = 10, 16
GROUP_TIMEOUT_S, IDLE_S = 3, 5     # the HTTP world idles past its timeout
IMPLS = ("psum_scatter", "ring")


def _problem(n, d=16, t=8, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    w = np.sort(rng.random((n, t)).astype(np.float32), axis=1)[:, ::-1]
    w[::7, t // 2:] = 0.0                    # zero-weight tails
    nodes = rng.integers(0, n, size=(n, t)).astype(np.int32)
    # an artifact never lists the origin itself (its visits are zeroed)
    nodes = np.where(nodes == np.arange(n)[:, None], (nodes + 1) % n, nodes)
    rows = np.array([0, 7, 55, n - 1, 3, 3], np.int32)   # a duplicate query
    return emb, (np.ascontiguousarray(w), nodes), rows


def _run(tmp_path_factory, world, n, http=False, graph=None):
    emb, nbhds, rows = _problem(n)
    p = {"emb": emb, "nbhds": nbhds, "rows": rows, "k": K, "k_cap": K_CAP,
         "http": http, "group_timeout_s": GROUP_TIMEOUT_S, "idle_s": IDLE_S}
    if graph is not None:
        p.update(track_ids=graph.track_ids[:n],
                 meta={t: graph.tracks[t] for t in graph.track_ids[:n]})
    results = run_world(tmp_path_factory.mktemp(f"serve{world}"), world,
                        "serve_checks", p)
    return p, results


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _run(tmp_path_factory, 4, 202)       # 2 pad rows at the end


@pytest.fixture(scope="module")
def world2(tmp_path_factory, graph):
    return _run(tmp_path_factory, 2, 203, http=True, graph=graph)


def _single(p, kind, quantized):
    """(weights, nodes) of the single-process index's formatted answers."""
    emb, nbhds, rows = p["emb"], p["nbhds"], p["rows"]
    if kind == "hybrid":
        ix = ts.HybridIndex(emb, nbhds=nbhds, k_cap=K_CAP, quantized=quantized,
                            device="cpu")
    else:
        ix = ts.EmbeddingIndex(emb, k_cap=K_CAP, quantized=quantized,
                               device="cpu")
    out = ix.knn_rows(rows, K)
    return (np.array([[o["score"] for o in r] for r in out]),
            np.array([[o["index"] for o in r] for r in out]))




@pytest.mark.parametrize("world", ["world2", "world4"])
@pytest.mark.parametrize("kind", ["knn", "hybrid"])
@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_equals_the_single_process_index(request, world, kind,
                                                 quantized):
    p, results = request.getfixturevalue(world)
    w_ref, n_ref = _single(p, kind, quantized)
    for out in results:
        w, n = out[(kind, quantized, "psum_scatter")]
        assert w.shape == (len(p["rows"]), K) and n.dtype == np.int32
        _same_up_to_ties(w, n, w_ref, n_ref)   # w_ref: rounded to 1e-6
        assert not (n == p["rows"][:, None]).any()         # self excluded


@pytest.mark.parametrize("world,g", [("world2", 2), ("world4", 4)])
@pytest.mark.parametrize("kind", ["knn", "hybrid"])
def test_sharded_equals_jax_sharded_index(request, world, g, kind):
    p, results = request.getfixturevalue(world)
    ix = JShardedServeIndex(p["emb"], mesh=j_make_mesh(
        n_dp=1, n_graph=g, devices=jax.devices()[:g]), nbhds=p["nbhds"],
        k_cap=K_CAP)
    fn = ix.hybrid_knn_rows if kind == "hybrid" else ix.knn_rows
    jw, jn = fn(p["rows"], k=K)
    w, n = results[0][(kind, False, "psum_scatter")]
    _same_up_to_ties(w, n, jw, jn)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_both_gather_forms_give_identical_results(request, world):
    _, results = request.getfixturevalue(world)
    for out in results:
        for key in [k for k in out if isinstance(k, tuple)
                    and k[-1] == "psum_scatter"]:
            for a, b in zip(out[key], out[key[:-1] + ("ring",)]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_pad_rows_are_never_returned(request, world):
    """203 rows over 2 ranks and 202 over 4 pad the last shard; no query
    of the whole catalog at the full k_cap returns a pad row."""
    p, results = request.getfixturevalue(world)
    n_items = len(p["emb"])
    for out in results:
        for quantized in (False, True):
            w, n = out[("every", quantized, "psum_scatter")]
            assert n.shape == (n_items, out["k_cap"])
            assert n.max() < n_items and np.isfinite(w).all()


def test_every_rank_answers_alike_and_refuses_alike(world4):
    _, results = world4
    for out in results[1:]:
        for key in [k for k in out if isinstance(k, tuple)]:
            for a, b in zip(out[key], results[0][key]):
                np.testing.assert_array_equal(a, b)
    for out in results:
        assert out["k_cap"] == K_CAP
        assert out["errors"] == ["IndexError", "ValueError", "ValueError"]


def test_http_roundtrip_through_rank_0(world2):
    """serve.serve over ShardedServingFrontend on rank 0 (QueryBatcher
    on), rank 1 following: health, single and batched kNN (the hybrid,
    with metadata), embed, and adds refused."""
    p, results = world2
    http = results[0]["http"]
    assert http["health"]["tracks"] == 203
    assert http["health"]["removed"] == 0
    nbrs = http["one"]["neighbors"]
    assert len(nbrs) == 5 and all(o["track"] != p["track_ids"][3]
                                  for o in nbrs)
    assert "name" in nbrs[0]
    w, n = results[0][("hybrid", False, "psum_scatter")]
    assert [o["index"] for o in nbrs] == n[4, :5].tolist()   # row 3
    assert [len(r) for r in http["batch"]["neighbors"]] == [4, 4, 4]
    unit = p["emb"][3] / np.linalg.norm(p["emb"][3])
    np.testing.assert_allclose(http["embed"]["embedding"], unit, rtol=1e-6)
    code, body = http["add"]
    assert code == 400 and "re-shard" in body["error"]
    assert "http" not in results[1]


def test_followers_outwait_the_serving_group_timeout(world2):
    """Rank 1 waited at ``multihost.wait_for_rank_0`` and then in
    ``follow`` for longer than the serving group's timeout each time (the
    control messages ride a group of their own), and still served."""
    _, results = world2
    http = results[0]["http"]
    assert http["idle_s"] > GROUP_TIMEOUT_S
    assert len(http["one"]["neighbors"]) == 5


def test_serve_sharded_cli_refuses_live_walk_hybrid():
    with pytest.raises(SystemExit):
        ts.main(["--emb", "x.npy", "--sharded", "--hybrid", "--device",
                 "cpu"])
    assert os.path.isfile(ts.__file__)
