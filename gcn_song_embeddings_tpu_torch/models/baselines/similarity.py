"""Link-prediction score recommenders: JaccardIndex, AdamicAdar and
Preferential (own copy of
gcn_song_embeddings_tpu/models/baselines/similarity.py).

Each scores its queries against every node on the host
(``ops.graph_ops``, bit-equal to the JAX package), then ranks the scores
with ``torch.topk`` on ``device`` (default: the GPU).  ``JaccardIndex``
is a real Jaccard index, not the reference's preferential-attachment
mis-binding.
"""

from __future__ import annotations

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.models.baselines.base import (
    PredictionModel,
)
from gcn_song_embeddings_tpu_torch.ops import graph_ops
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


class SimpleSimilarity(PredictionModel):
    """Base: ``score_fn(adj, queries)`` -> [q, N] scores, then top-k on
    the device, ``batch_size`` queries at a time."""

    score_fn = None  # staticmethod(adj, queries) -> np.ndarray

    def __init__(self, projected: bool = True, batch_size: int = 256,
                 device=None):
        self.projected = projected
        self.batch_size = batch_size
        self.device = device

    def train(self, graph, ids, train_set, test_set, features) -> None:
        self.adj = graph_ops.adjacency_tracks(graph,
                                              projected=self.projected)
        self.n = len(ids)
        self._dev = resolve_device(self.device)

    def knn(self, nodeset, k):
        nodeset = np.asarray(nodeset, dtype=np.int64)
        w_out, n_out = [], []
        for start in range(0, len(nodeset), self.batch_size):
            q = nodeset[start:start + self.batch_size]
            scores = type(self).score_fn(self.adj, q)[:, :self.n]
            w, n = torch.topk(torch.as_tensor(scores, device=self._dev), k,
                              dim=1)
            w_out.append(w.cpu())
            n_out.append(n.to(torch.int32).cpu())
        return torch.cat(w_out).numpy(), torch.cat(n_out).numpy()


class JaccardIndex(SimpleSimilarity):
    score_fn = staticmethod(graph_ops.jaccard_scores)


class AdamicAdar(SimpleSimilarity):
    score_fn = staticmethod(graph_ops.adamic_adar_scores)


class Preferential(SimpleSimilarity):
    score_fn = staticmethod(graph_ops.preferential_scores)
