"""The port's node2vec (``ops/node2vec.py``: alias tables, biased walks;
``models/baselines/node2vec.py``: skip-gram, ``FastNode2Vec``) vs the JAX
package, on the CPU.

Tolerances: the alias tables are the same float64 stack algorithm, so
equal bit for bit; the walks fed JAX's slot, alias and accept draws equal
JAX's walks exactly; skip-gram fed JAX's initial ``W_in`` and step draws
within rtol 1e-5 / atol 1e-7 of JAX's (f32 scatter-adds of duplicate ids
summed in another order, the rate's f32 linspace rounded apart).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.models.baselines.node2vec import (
    train_skipgram as j_train_skipgram,
)
from gcn_song_embeddings_tpu.ops import graph_ops as jgraph_ops
from gcn_song_embeddings_tpu.ops.node2vec import (
    build_alias_graph as j_build_alias_graph,
    node2vec_walks as j_node2vec_walks,
)
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.models.baselines import FastNode2Vec
from gcn_song_embeddings_tpu_torch.models.baselines.node2vec import (
    SkipgramDraws,
    skipgram_steps,
    train_skipgram,
)
from gcn_song_embeddings_tpu_torch.ops.graph_ops import project_bipartite
from gcn_song_embeddings_tpu_torch.ops.node2vec import (
    SLOT_RANGE,
    WalkDraws,
    _alias_sample,
    build_alias_graph,
    draw_walks,
    node2vec_walks,
)
from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def proj(dataset_dir):
    return project_bipartite(SongGraph(dataset_dir))


def test_projection_equals_jax(graph, proj):
    want = jgraph_ops.project_bipartite(graph)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(proj, name),
                                      getattr(want, name))


def test_alias_tables_equal_jax(proj):
    rng = np.random.default_rng(0)
    cases = [(proj.indptr, proj.indices, proj.data.astype(np.float64)),
             (proj.indptr, proj.indices,
              rng.uniform(0.1, 5.0, proj.nnz)),
             (proj.indptr, proj.indices, None),
             (np.array([0, 3, 4, 4]), np.array([0, 1, 2, 0]),
              np.array([1.0, 2.0, 7.0, 1.0]))]
    for indptr, indices, weights in cases:
        got = build_alias_graph(indptr, indices, weights, device="cpu")
        want = j_build_alias_graph(indptr, indices, weights)
        for name in ("indptr", "indices", "prob", "alias"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))


def test_unsorted_rows_are_refused():
    with pytest.raises(ValueError, match="increasing"):
        build_alias_graph(np.array([0, 3, 4]), np.array([0, 2, 1, 0]),
                          device="cpu")
    # a row may start below the previous row's end
    g = build_alias_graph(np.array([0, 2, 2, 4]), np.array([3, 5, 0, 1]),
                          device="cpu")
    assert g.n == 3


def _jax_walk_draws(seed, n, walk_length, rounds):
    """JAX's node2vec_walks draws from its own key schedule."""
    key = jax.random.PRNGKey(seed)
    k0, key = jax.random.split(key)
    k1, k2 = jax.random.split(k0)
    slot0 = jax.random.randint(k1, (n,), 0, SLOT_RANGE)
    alias0 = jax.random.uniform(k2, (n,))
    slots, alias_u, accept_u = [], [], []
    for step_key in jax.random.split(key, walk_length - 2):
        s, a, c = [], [], []
        for rk in jax.random.split(step_key, rounds):
            k1, k2 = jax.random.split(rk)
            ka, kb = jax.random.split(k1)
            s.append(jax.random.randint(ka, (n,), 0, SLOT_RANGE))
            a.append(jax.random.uniform(kb, (n,)))
            c.append(jax.random.uniform(k2, (n,)))
        slots.append(s)
        alias_u.append(a)
        accept_u.append(c)
    return WalkDraws(*(torch.from_numpy(np.array(x))
                       for x in (slot0, alias0, slots, alias_u, accept_u)))


@pytest.mark.parametrize("p,q,rounds", [(2.0, 0.5, 3), (0.5, 4.0, 2),
                                        (1.0, 1.0, 1)])
def test_walks_fed_jax_draws_equal_jax(proj, p, q, rounds):
    n, walk_length, seed = 64, 12, 3
    starts = np.arange(0, 500, 500 // n)[:n].astype(np.int32)
    weights = proj.data.astype(np.float64)
    jg = j_build_alias_graph(proj.indptr, proj.indices, weights)
    want = np.asarray(j_node2vec_walks(jg, jnp.asarray(starts), walk_length,
                                       p, q, jax.random.PRNGKey(seed),
                                       rejection_rounds=rounds))
    g = build_alias_graph(proj.indptr, proj.indices, weights, device="cpu")
    got = node2vec_walks(g, torch.from_numpy(starts), walk_length, p, q,
                         _jax_walk_draws(seed, n, walk_length, rounds))
    np.testing.assert_array_equal(got.numpy(), want)


def test_walks_with_own_draws_follow_edges(proj):
    g = build_alias_graph(proj.indptr, proj.indices,
                          proj.data.astype(np.float64), device="cpu")
    starts = torch.arange(32)
    walks = node2vec_walks(g, starts, 10, 2.0, 0.5,
                           draw_walks(32, 10, 3, seeded_generator([0], "cpu")))
    assert walks.shape == (32, 10)
    np.testing.assert_array_equal(walks[:, 0].numpy(), np.arange(32))
    indptr, indices = proj.indptr, proj.indices
    for row in walks.numpy():
        for u, v in zip(row[:-1], row[1:]):
            nbrs = indices[indptr[u]:indptr[u + 1]]
            assert v in nbrs or (len(nbrs) == 0 and u == v)


def test_alias_sampling_distribution():
    g = build_alias_graph(np.array([0, 3, 4]), np.array([0, 1, 2, 0]),
                          np.array([1.0, 2.0, 7.0, 1.0]), device="cpu")
    gen = seeded_generator([0], "cpu")
    d = draw_walks(4000, 2, 1, gen)
    draws = _alias_sample(g, torch.zeros(4000, dtype=torch.long), d.slot0,
                          d.alias0).numpy()
    freq = np.bincount(draws, minlength=3) / 4000
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.03)


def _jax_skipgram_draws(seed, n_walks, walk_len, n_nodes, dim, context,
                        negatives, n_steps, batch):
    """JAX's train_skipgram initial W_in and step draws, from its own key
    schedule."""
    key = jax.random.PRNGKey(seed)
    k_in, _, key = jax.random.split(key, 3)
    W_in = (jax.random.uniform(k_in, (n_nodes, dim)) - 0.5) / dim
    steps = []
    for step_key in jax.random.split(key, n_steps):
        kw, kp, ko, kn = jax.random.split(step_key, 4)
        steps.append(SkipgramDraws(*(torch.from_numpy(np.array(x)) for x in (
            jax.random.randint(kw, (batch,), 0, n_walks),
            jax.random.randint(kp, (batch,), 0, walk_len),
            jax.random.randint(ko, (batch,), 1, context + 1),
            jax.random.uniform(kn, (batch,)),
            jax.random.randint(jax.random.fold_in(kn, 1),
                               (batch, negatives), 0, n_nodes)))))
    return torch.from_numpy(np.array(W_in)), steps


def test_skipgram_fed_jax_draws_equal_jax():
    rng = np.random.default_rng(1)
    n_nodes, dim, context, negatives, epochs, batch, seed = 30, 8, 3, 5, 2, \
        64, 9
    walks = rng.integers(0, n_nodes, (40, 8)).astype(np.int32)
    n_steps = skipgram_steps(40, 8, context, epochs, batch)
    assert n_steps == 30
    want = np.asarray(j_train_skipgram(
        jnp.asarray(walks), n_nodes, dim=dim, context=context,
        negatives=negatives, epochs=epochs, batch=batch, seed=seed))
    W_in, steps = _jax_skipgram_draws(seed, 40, 8, n_nodes, dim, context,
                                      negatives, n_steps, batch)
    got = train_skipgram(torch.from_numpy(walks), n_nodes, dim=dim,
                         context=context, negatives=negatives, epochs=epochs,
                         batch=batch, seed=seed, W_in=W_in,
                         draws=lambda step: steps[step])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert not np.allclose(got, W_in.numpy())      # it trained


def test_node2vec_learns_clusters(dataset_dir, positives):
    g = SongGraph(dataset_dir)
    m = FastNode2Vec(dim=32, epochs=5, walks_per_node=5, device="cpu")
    m.train(g, g.track_ids, positives[:1200], None, None)
    assert m.embedding.shape == (g.n_items, 32)
    np.testing.assert_array_equal(m.embed([4, 2]), m.embedding[[4, 2]])
    _, knn_n = m.knn(np.arange(g.n_items), 100)
    assert M.hit_rate(knn_n, positives[1200:], 100) > 0.4   # random ~0.2
