"""The port's graph algebra and host-scored baselines (``ops.graph_ops``,
``JaccardIndex`` / ``AdamicAdar`` / ``Preferential``, ``JaccardFast``,
``merge_topk`` against ``merge_ranked_lists``, ``WalkEmbedHybrid`` and
``PinSageWrapper``) vs the JAX package, on the CPU.

Tolerances: ``graph_ops`` and the similarity scores are the same scipy /
numpy on the same inputs, so equal bit for bit; top-k ids equal up to
ties (equal scores may list in another order); JaccardFast's scores
within 1e-6 (f32 division on both sides); ``merge_topk`` equals the
oracle's ids and its finite weights within rtol 1e-6; the hybrid fed
JAX's walk uniforms gives JAX's ids exactly and its weights within 1e-6
(cosines summed in another order).
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.models.baselines import (
    AdamicAdar as JAdamicAdar,
    JaccardFast as JJaccardFast,
    JaccardIndex as JJaccardIndex,
    Preferential as JPreferential,
    WalkEmbedHybrid as JWalkEmbedHybrid,
)
from gcn_song_embeddings_tpu.models.baselines.simple import (
    merge_ranked_lists as j_merge_ranked_lists,
)
from gcn_song_embeddings_tpu.ops import graph_ops as jgraph_ops
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.models.baselines import (
    AdamicAdar,
    JaccardFast,
    JaccardIndex,
    PinSageWrapper,
    Preferential,
    WalkEmbedHybrid,
)
from gcn_song_embeddings_tpu_torch.models.baselines.simple import (
    merge_ranked_lists,
)
from gcn_song_embeddings_tpu_torch.ops import graph_ops
from gcn_song_embeddings_tpu_torch.ops.merge import merge_topk
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port_graph(dataset_dir):
    return SongGraph(dataset_dir,
                     features_file=os.path.join(dataset_dir, "features.npy"))


def _same_up_to_ties(got_w, got_n, want_w, scores, atol=1e-6):
    """Equal top-k lists up to the order of equal scores: the scores
    within atol of JAX's, ids distinct in each row, and each listed id's
    own score (``scores`` [q, N], the JAX package's) equal to the score
    listed beside it."""
    np.testing.assert_allclose(got_w, want_w, atol=atol)
    assert all(len(set(row)) == len(row) for row in got_n.tolist())
    own = np.take_along_axis(scores, got_n.astype(np.int64), axis=1)
    np.testing.assert_allclose(own, got_w, atol=atol)


def _same_csr(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_graph_ops_equal_jax(graph, port_graph):
    _same_csr(graph_ops.project_bipartite(port_graph),
              jgraph_ops.project_bipartite(graph))
    queries = np.array([0, 5, 17, 499])
    for projected in (True, False):
        adj = graph_ops.adjacency_tracks(port_graph, projected=projected)
        _same_csr(adj, jgraph_ops.adjacency_tracks(graph,
                                                   projected=projected))
        for name in ("preferential_scores", "jaccard_scores",
                     "adamic_adar_scores", "common_neighbor_matrix"):
            got = getattr(graph_ops, name)(adj, queries)
            want = getattr(jgraph_ops, name)(adj, queries)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("port_cls,jax_cls,projected", [
    (JaccardIndex, JJaccardIndex, True),
    (AdamicAdar, JAdamicAdar, True),
    (AdamicAdar, JAdamicAdar, False),
    (Preferential, JPreferential, True)])
def test_similarity_recommenders_match_jax(graph, port_graph, positives,
                                           port_cls, jax_cls, projected):
    got = port_cls(projected=projected, batch_size=96, device="cpu")
    want = jax_cls(projected=projected, batch_size=96)
    got.train(port_graph, port_graph.track_ids, positives, None, None)
    want.train(graph, graph.track_ids, positives, None, None)
    nodes = np.arange(0, 500, 3)
    gw, gn = got.knn(nodes, 20)
    ww, _ = want.knn(nodes, 20)
    assert gw.dtype == np.float32 and gn.dtype == np.int32
    _same_up_to_ties(gw, gn, np.asarray(ww),
                     type(want).score_fn(want.adj, nodes))


def test_jaccard_index_learns_structure(port_graph, positives):
    m = JaccardIndex(device="cpu")
    m.train(port_graph, port_graph.track_ids, positives[:1200], None, None)
    _, knn_n = m.knn(np.arange(port_graph.n_items), 100)
    assert M.hit_rate(knn_n, positives[1200:], 100) > 0.35


def test_jaccard_fast_matches_jax(graph, port_graph):
    got, want = JaccardFast(device="cpu"), JJaccardFast()
    got.train(port_graph, port_graph.track_ids, None, None, None)
    want.train(graph, graph.track_ids, None, None, None)
    np.testing.assert_array_equal(got.nbh_sizes, want.nbh_sizes)
    for nodes, k in ((np.arange(6), 11), (np.arange(100, 400), 40)):
        gw, gn = got.knn(nodes, k)
        ww, _ = want.knn(nodes, k)
        assert gw.shape == gn.shape == (len(nodes), k - 1)   # k-1 wide
        inter = np.asarray(want.intersections[nodes].todense(), np.float32)
        deg = want.nbh_sizes.astype(np.float32)
        scores = inter / (deg[nodes][:, None] + deg[None, :] - inter
                          + np.float32(1e-10))
        _same_up_to_ties(gw, gn, np.asarray(ww), scores)
    # brute-force Jaccard of query 0 against its top entry
    ct = np.zeros((port_graph.n_cols, port_graph.n_items))
    c2i = port_graph.c2i
    for c in range(port_graph.n_cols):
        ct[c, c2i.indices[c2i.indptr[c]:c2i.indptr[c + 1]]] = 1
    inter = ct[:, 0] @ ct
    jac = inter / (ct[:, 0].sum() + ct.sum(0) - inter + 1e-10)
    w, _ = got.knn(np.arange(1), 11)
    np.testing.assert_allclose(w[0, 0], np.sort(jac)[::-1][1], atol=1e-6)


def _ranked_lists(rng, B, n, k, zero_tail=False):
    """Top-k-style lists: distinct nodes a row, descending positive
    weights; with ``zero_tail`` a zero-weight tail repeating earlier
    nodes (the visit-count contract)."""
    nodes = np.stack([rng.permutation(n)[:k] for _ in range(B)]
                     ).astype(np.int32)
    w = np.sort(rng.random((B, k)).astype(np.float32), axis=1)[:, ::-1] + .1
    if zero_tail:
        for i, v in enumerate(rng.integers(0, k + 1, size=B)):
            w[i, v:] = 0.0
            if v:
                nodes[i, v:] = nodes[i, rng.integers(0, v)]
    return np.ascontiguousarray(w), nodes


@pytest.mark.parametrize("seed,n,head_k,tail_k", [
    (0, 400, 25, 25), (1, 400, 30, 12), (2, 60, 10, 59), (3, 8, 6, 7)])
def test_merge_topk_equals_oracle(seed, n, head_k, tail_k):
    rng = np.random.default_rng(seed)
    hw, hn = _ranked_lists(rng, 16, n, head_k, zero_tail=True)
    tw, tn = _ranked_lists(rng, 16, n, tail_k)
    ow, on = merge_ranked_lists(hw, hn, tw, tn)
    jw, jn = j_merge_ranked_lists(hw, hn, tw, tn)
    np.testing.assert_array_equal(on, jn)
    np.testing.assert_array_equal(ow, jw)
    dw, dn = merge_topk(*(torch.from_numpy(a) for a in (hw, hn, tw, tn)))
    dw, dn = dw.numpy(), dn.numpy()
    np.testing.assert_array_equal(on, dn)
    finite = np.isfinite(ow)
    np.testing.assert_array_equal(finite, np.isfinite(dw))
    np.testing.assert_allclose(ow[finite], dw[finite], rtol=1e-6)


def test_walk_embed_hybrid_fed_jax_uniforms_matches(graph, port_graph,
                                                    positives):
    n_hops, bs, k, seed = 50, 64, 30, 2
    emb = np.random.default_rng(3).normal(size=(500, 12)).astype(np.float32)
    train = positives[:1000]
    want = JWalkEmbedHybrid(emb, n_hops=n_hops, seed=seed, batch_size=bs)
    want.train(graph, graph.track_ids, train, None, None)
    got = WalkEmbedHybrid(emb, n_hops=n_hops, seed=seed, batch_size=bs,
                          device="cpu")
    got.train(port_graph, port_graph.track_ids, train, None, None)

    def jax_uniforms(start, n_walkers):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), start)
        u = np.asarray(jax.random.uniform(key, (n_hops, bs, 3)))
        return torch.from_numpy(u[:, :n_walkers].copy())

    got.walker.uniforms = jax_uniforms
    nodes = np.arange(7, 7 + 150)
    gw, gn = got.knn(nodes, k)
    ww, wn = want.knn(nodes, k)
    np.testing.assert_array_equal(gn, np.asarray(wn))
    np.testing.assert_allclose(gw, np.asarray(ww), atol=1e-6)
    # every row starts with the walk's head, no node twice
    assert all(len(set(row)) == k for row in gn.tolist())


def test_walk_embed_hybrid_from_a_run_dir(port_graph, positives, tmp_path):
    emb = np.random.default_rng(4).normal(size=(500, 8)).astype(np.float32)
    np.save(tmp_path / "emb.npy", emb)
    m = WalkEmbedHybrid(str(tmp_path), n_hops=40, device="cpu")
    m.train(port_graph, port_graph.track_ids, positives[:1000], None, None)
    np.testing.assert_array_equal(m.embedding, emb)
    w, n = m.knn(np.arange(20), 25)
    assert n.shape == (20, 25) and np.isfinite(w).all()
    assert not (n == np.arange(20)[:, None]).any()


def test_pinsage_wrapper_trains_and_embeds(port_graph, positives, tmp_path):
    m = PinSageWrapper(
        train_params={"train.epochs": 1, "train.batches_per_epoch": 3,
                      "train.batch_size": 8, "walk.n_hops": 40,
                      "walk.t_precompute": 20, "model.hidden_dim": 16,
                      "model.out_dim": 8},
        run_name="wrap", log=False, base_run_dir=str(tmp_path),
        device="cpu")
    m.train(port_graph, port_graph.track_ids, positives[:1000], None,
            port_graph.features)
    assert m.embedding.shape == (port_graph.n_items, 8)
    assert np.isfinite(m.embedding).all()
    np.testing.assert_array_equal(
        np.load(tmp_path / "wrap" / "emb.npy"), m.embedding)
    np.testing.assert_array_equal(m.embed([3, 1]), m.embedding[[3, 1]])
    w, n = m.knn(np.arange(10), 5)
    assert n.shape == (10, 5) and np.isfinite(w).all()
