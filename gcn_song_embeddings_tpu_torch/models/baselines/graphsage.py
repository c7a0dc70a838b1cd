"""Unsupervised GNN-embedding baseline: GraphSAGE, GAT or GCN (own copy
of gcn_song_embeddings_tpu/models/baselines/graphsage.py).

A two-layer sampled encoder (``models.gnnlib``) trained with a triplet
margin loss on 1-hop positives against uniform negatives, over the
(optionally projected) track graph, on ``device`` (default: the GPU).
"""

from __future__ import annotations

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.models.baselines.base import (
    EmbeddingModel,
)
from gcn_song_embeddings_tpu_torch.models.gnnlib import GNNCore
from gcn_song_embeddings_tpu_torch.ops.graph_ops import adjacency_tracks
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


class GraphSAGEUnsup:
    """The unsupervised ``GNNCore``; ``layer`` picks the aggregator: sage
    (default), gcn or gat."""

    def __init__(self, hidden_dim: int = 128, out_dim: int = 128,
                 n_sample: int = 10, steps: int = 1500, batch: int = 512,
                 lr: float = 1e-3, margin: float = 3.0, seed: int = 0,
                 layer: str = "sage", device=None):
        self.core = GNNCore(layer=layer, task="unsupervised",
                            hidden_dim=hidden_dim, out_dim=out_dim,
                            n_sample=n_sample, steps=steps, batch=batch,
                            lr=lr, margin=margin, seed=seed, device=device)
        self.out_dim = out_dim

    @property
    def losses(self):
        return self.core.losses

    def fit(self, indptr: np.ndarray, indices: np.ndarray,
            features: np.ndarray | None, n_nodes: int) -> np.ndarray:
        return self.core.fit(indptr, indices, features, n_nodes)


class GraphSAGE(EmbeddingModel):
    """GNN-embedding recommender over the track graph; ``layer="gcn"`` or
    ``"gat"`` for the sibling encoders (keyword arguments go to
    ``GraphSAGEUnsup``)."""

    def __init__(self, projected: bool = True, device=None, **kwargs):
        self.projected = projected
        self.device = device
        self.kwargs = kwargs
        self.embedding: np.ndarray | None = None

    def train(self, graph, ids, train_set, test_set, features) -> None:
        adj = adjacency_tracks(graph, projected=self.projected).tocsr()
        self.model = GraphSAGEUnsup(device=self.device, **self.kwargs)
        feats = np.asarray(features, dtype=np.float32) \
            if features is not None else None
        self.embedding = self.model.fit(adj.indptr, adj.indices, feats,
                                        len(ids))
        self._table = torch.as_tensor(self.embedding,
                                      device=resolve_device(self.device))

    def embed(self, nodeset):
        return self.embedding[np.asarray(nodeset)]

    def knn(self, nodeset, k):
        return knn_from_emb(self._table, np.asarray(nodeset), k)
