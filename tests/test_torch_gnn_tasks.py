"""The port's GNN tasks learn (``models/gnnlib.py``, ``models/baselines/
graphsage.py``), on the CPU, at the JAX suite's bars (tests/test_gnnlib.py):
unsupervised GraphSAGE / GCN / GAT embeddings rank held-out positives
above chance, classification recovers a planted partition, regression
predicts a neighbor mean.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.models.baselines import GraphSAGE
from gcn_song_embeddings_tpu_torch.models.gnnlib import GNNCore
from test_torch_gnnlib import _community_csr
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port_graph(dataset_dir):
    return SongGraph(dataset_dir,
                     features_file=os.path.join(dataset_dir, "features.npy"))


@pytest.mark.parametrize("layer", ["sage", "gcn", "gat"])
def test_unsup_variants_learn_clusters(port_graph, positives, layer):
    """Held-out positives ranked well above chance (~0.2 at hit@100 over
    500 tracks): the JAX suite's 0.4 for sage, 0.7 for gcn and gat."""
    m = GraphSAGE(hidden_dim=64, out_dim=32, steps=400, layer=layer,
                  device="cpu")
    m.train(port_graph, port_graph.track_ids, positives[:1200], None,
            port_graph.features)
    assert m.embedding.shape == (port_graph.n_items, 32)
    assert m.model.losses[-50:].mean() < m.model.losses[:50].mean()
    _, knn_n = m.knn(np.arange(port_graph.n_items), 100)
    hr = M.hit_rate(knn_n, positives[1200:], 100)
    assert hr > (0.4 if layer == "sage" else 0.7), f"{layer} hit@100 {hr}"


@pytest.mark.parametrize("layer", ["sage", "gcn", "gat"])
def test_classification_planted_partition(layer):
    indptr, indices, labels = _community_csr()
    n = len(labels)
    train_mask = np.random.default_rng(3).random(n) < 0.5
    core = GNNCore(layer=layer, task="classification", hidden_dim=32,
                   steps=300, batch=128, seed=1, device="cpu")
    core.fit(indptr, indices, np.eye(n, dtype=np.float32), n,
             labels=np.where(train_mask, labels, -1))
    acc = (core.predict(np.nonzero(~train_mask)[0])
           == labels[~train_mask]).mean()
    assert acc > 0.6, f"{layer} test accuracy {acc}"  # chance = 0.25


def test_regression_predicts_neighbor_mean():
    indptr, indices, _ = _community_csr(n=500, seed=5)
    n = len(indptr) - 1
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    y = np.array([feats[indices[indptr[u]:indptr[u + 1]], 0].mean()
                  for u in range(n)])
    train_mask = rng.random(n) < 0.6
    core = GNNCore(layer="sage", task="regression", hidden_dim=32,
                   n_sample=32, steps=600, batch=128, seed=2, device="cpu")
    core.fit(indptr, indices, feats, n, labels=np.where(train_mask, y,
                                                        np.nan))
    pred = core.predict(np.nonzero(~train_mask)[0], n_draws=8)
    target = y[~train_mask]
    r2 = 1.0 - float(((pred - target) ** 2).sum()) / float(
        ((target - target.mean()) ** 2).sum())
    assert r2 > 0.4, f"neighbor-mean regression R^2 {r2}"
