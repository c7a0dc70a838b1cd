"""The port's GNN family (``models/gnnlib.py``, ``models/baselines/
graphsage.py``) vs the JAX package, on the CPU.

Tolerances: one layer on JAX's parameters carried across within rtol
1e-5 / atol 1e-6 (f32 products in another order); three Adam steps fed
JAX's initial parameters and neighbor draws within rtol 1e-4 / atol 1e-5
(the bar of tests/test_trainer.py's 3-step trajectories: Adam's
normalised update magnifies the rounding of small gradients);
``degree_onehot`` equal bit for bit.  The tasks' learning bars are in
tests/test_torch_gnn_tasks.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.models.gnnlib import (
    GNNCore as JGNNCore,
    degree_onehot as j_degree_onehot,
    gnn_layer_apply as j_gnn_layer_apply,
    init_gnn_layer as j_init_gnn_layer,
)
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.models.baselines import GraphSAGE
from gcn_song_embeddings_tpu_torch.models.gnnlib import (
    DRAW_RANGE,
    GNN,
    GNNCore,
    degree_onehot,
    gnn_layer_apply,
    params_from_jax,
)
from gcn_song_embeddings_tpu_torch.ops.graph_ops import adjacency_tracks
from torch_threads import one_torch_thread  # noqa: F401


def _community_csr(n=200, k=4, intra=6, inter=1, seed=0):
    """Planted-partition graph: k communities, dense inside, sparse
    across -> (indptr, indices, labels)."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n) % k
    rows = [[] for _ in range(n)]
    for c in range(k):
        members = np.nonzero(labels == c)[0]
        for u in members:
            for v in rng.choice(members, size=intra, replace=False):
                if u != v:
                    rows[u].append(int(v))
                    rows[v].append(int(u))
    for _ in range(n * inter):
        u, v = rng.integers(0, n, 2)
        if labels[u] != labels[v]:
            rows[u].append(int(v))
            rows[v].append(int(u))
    indptr = np.zeros(n + 1, dtype=np.int32)
    indices = []
    for u in range(n):
        indices.extend(sorted(set(rows[u])) or [int(u)])
        indptr[u + 1] = len(indices)
    return indptr, np.asarray(indices, dtype=np.int32), labels


@pytest.mark.parametrize("layer", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("activate", [True, False])
def test_layer_apply_on_jax_params_equals_jax(layer, activate):
    p = j_init_gnn_layer(jax.random.PRNGKey(0), layer, 16, 8)
    rng = np.random.default_rng(0)
    h_self = rng.normal(size=(5, 16)).astype(np.float32)
    h_nb = rng.normal(size=(5, 3, 16)).astype(np.float32)
    want = np.asarray(j_gnn_layer_apply(p, layer, h_self, h_nb,
                                        activate=activate))
    got = gnn_layer_apply(params_from_jax({"l": p}, "cpu")["l"], layer,
                          torch.from_numpy(h_self), torch.from_numpy(h_nb),
                          activate=activate).numpy()
    assert got.shape == (5, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gat_attention_is_convex_combination():
    p = params_from_jax({"l": j_init_gnn_layer(jax.random.PRNGKey(1),
                                               "gat", 4, 4)}, "cpu")["l"]
    p["W"] = torch.eye(4)
    out = gnn_layer_apply(p, "gat", torch.tensor([[1.0, 0, 0, 0]]),
                          torch.tensor([[[0, 1.0, 0, 0], [0, 0, 1.0, 0]]]),
                          activate=False).numpy()
    assert out.min() >= -1e-6
    np.testing.assert_allclose(out.sum(), 1.0, atol=1e-5)


def _randint(key, shape):
    return torch.from_numpy(np.array(jax.random.randint(key, shape, 0,
                                                        DRAW_RANGE)))


def _jax_draws(core, step_keys, n_nodes, pool):
    """JAX's per-step draws of GNNCore.fit, from its own keys."""
    B, S = core.batch, core.n_sample

    def encode(key, m):
        ka, kb, kc = jax.random.split(key, 3)
        return (_randint(ka, (m, S)), _randint(kb, (m * S, S)),
                _randint(kc, (m, S)))

    out = []
    for k in step_keys:
        if core.task == "unsupervised":
            ks, kp, kn, ke = jax.random.split(k, 4)
            out.append({
                "nodes": torch.from_numpy(np.array(
                    jax.random.randint(ks, (B,), 0, n_nodes))),
                "pos": _randint(kp, (B, 1)),
                "neg": torch.from_numpy(np.array(
                    jax.random.randint(kn, (B,), 0, n_nodes))),
                "encode": encode(ke, 3 * B)})
        else:
            ks, ke = jax.random.split(k)
            out.append({"idx": torch.from_numpy(np.array(
                jax.random.randint(ks, (B,), 0, pool))),
                "encode": encode(ke, B)})
    return out


@pytest.mark.parametrize("layer,task", [
    ("sage", "unsupervised"), ("gcn", "unsupervised"),
    ("gat", "unsupervised"), ("gat", "classification"),
    ("sage", "regression")])
def test_three_adam_steps_fed_jax_draws_equal_jax(layer, task):
    indptr, indices, labels = _community_csr(n=120, seed=2)
    n = len(labels)
    feats = np.random.default_rng(1).normal(size=(n, 12)).astype(np.float32)
    kw = dict(layer=layer, task=task, hidden_dim=16, out_dim=8, n_sample=4,
              steps=3, batch=32, lr=1e-2, seed=3)
    y = None
    if task == "classification":
        y = np.where(np.arange(n) % 3 == 0, -1, labels)
    elif task == "regression":
        y = np.where(np.arange(n) % 4 == 0, np.nan, feats[:, 0] * 2.0)
    want = JGNNCore(**kw)
    want.fit(indptr, indices, feats, n, labels=y)

    key = jax.random.PRNGKey(kw["seed"])
    k1, k2, key = jax.random.split(key, 3)
    head = 8 if task == "unsupervised" else (
        int(labels.max()) + 1 if task == "classification" else 1)
    init = {"l1": j_init_gnn_layer(k1, layer, 12, 16),
            "l2": j_init_gnn_layer(k2, layer, 16, head)}
    pool = None if y is None else int(
        (y >= 0).sum() if task == "classification" else np.isfinite(y).sum())
    draws = _jax_draws(want, jax.random.split(key, 3), n, pool)

    got = GNNCore(device="cpu", **kw)
    got.init_params = lambda in_dim, out_dim, dev: params_from_jax(init,
                                                                   dev)
    got.draws = lambda step, n_nodes, pool: draws[step]
    got.fit(indptr, indices, feats, n, labels=y)
    np.testing.assert_allclose(got.losses, np.asarray(want.losses),
                               rtol=1e-4, atol=1e-5)
    for name in ("l1", "l2"):
        for leaf, value in want._params[name].items():
            np.testing.assert_allclose(got._params[name][leaf].numpy(),
                                       np.asarray(value), rtol=1e-4,
                                       atol=1e-5)


def test_degree_onehot_equals_jax():
    deg = np.array([0, 1, 2, 7, 10, 1000, 10 ** 9])
    np.testing.assert_array_equal(degree_onehot(deg), j_degree_onehot(deg))
    np.testing.assert_array_equal(degree_onehot(deg, 4),
                                  j_degree_onehot(deg, 4))


def test_facade_roundtrip():
    indptr, indices, labels = _community_csr(n=80, k=2)
    g = GNN(model="GCN", task="classification", hidden_dim=16, steps=60,
            batch=64, device="cpu")
    g.fit(indptr, indices, labels=np.asarray(labels))
    assert g.generate_embeddings().shape == (80, 2)   # logits, 2 classes
    pred = g.predict(np.arange(80))
    assert pred.shape == (80,) and set(np.unique(pred)) <= {0, 1}
    with pytest.raises(ValueError):
        GNN(model="transformer")
    with pytest.raises(ValueError):
        GNNCore(layer="sage", task="classification", device="cpu").fit(
            indptr, indices, None, 80, labels=None)
    with pytest.raises(RuntimeError):
        GNNCore(device="cpu").transform(np.arange(3))


@pytest.fixture(scope="module")
def port_graph(dataset_dir):
    return SongGraph(dataset_dir)


def test_graphsage_degree_fallback_and_layer_kwarg(port_graph, positives):
    m = GraphSAGE(hidden_dim=8, out_dim=4, steps=10, layer="gcn",
                  device="cpu")
    m.train(port_graph, port_graph.track_ids, positives[:100], None, None)
    assert m.model.core.layer == "gcn"
    assert m.embedding.shape == (port_graph.n_items, 4)
    assert np.isfinite(m.embedding).all()
    assert adjacency_tracks(port_graph).shape[0] == port_graph.n_items
    w, n = m.knn(np.arange(5), 7)
    assert n.shape == (5, 7)
