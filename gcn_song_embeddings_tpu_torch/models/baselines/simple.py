"""Simple baselines: Random, EmbLoader, PersPageRank (own copy of part of
gcn_song_embeddings_tpu/models/baselines/simple.py).

``Random`` draws from numpy exactly as the JAX package does, so its lists
are equal.  ``EmbLoader`` serves a saved embedding matrix through the
cosine kNN sweep on its device.  ``PersPageRank`` walks at query time
(kernel K1 on the GPU) and ranks the visits; its uniforms come from a
generator per query block, keyed on (seed, block start) as the sweep's
``block_generator``, where the JAX package folds the block start into a
threefry key.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    augment_with_colisten,
)
from gcn_song_embeddings_tpu_torch.models.baselines.base import (
    EmbeddingModel,
    PredictionModel,
)
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    block_generator,
    sample_neighborhood_topt_tables,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    draw_uniforms,
    fused_walk_tables,
)
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


class Random(PredictionModel):
    """Random recommendations, keyed on the queries so batched sweeps do
    not repeat one permutation per batch."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def train(self, graph, ids, train_set, test_set, features) -> None:
        self.n = len(ids)

    def knn(self, nodeset, k):
        nodeset = np.asarray(nodeset)
        rng = np.random.default_rng(
            [self.seed, int(nodeset[0]) if len(nodeset) else 0,
             len(nodeset)])
        nq = len(nodeset)
        if k * 4 >= self.n:
            # dense catalogs: per-query permutations are cheap and exact
            nodes = np.stack([rng.permutation(self.n)[:k]
                              for _ in range(nq)])
        else:
            # k << n: oversample with replacement, dedupe per row, top up
            # until k distinct samples exist
            cand = rng.integers(0, self.n, size=(nq, 4 * k))
            nodes = np.empty((nq, k), dtype=np.int64)
            for i in range(nq):
                u = np.unique(cand[i])
                while u.size < k:
                    u = np.unique(np.concatenate(
                        [u, rng.integers(0, self.n, 4 * k)]))
                nodes[i] = rng.permutation(u)[:k]
        return np.ones_like(nodes, dtype=np.float32), nodes.astype(np.int32)


class EmbLoader(EmbeddingModel):
    """Serve precomputed embeddings as a recommender: an explicit ``.npy``
    path, a run dir holding ``emb.npy``, or a directory of per-id
    ``.npy`` / ``.pt`` files (``data.graph.load_feature_dir``).  The
    table is put on ``device`` (default: the GPU) once, at ``train``."""

    def __init__(self, load_path: str, device=None):
        self.load_path = load_path
        self.device = device
        self.embedding: np.ndarray | None = None

    def train(self, graph, ids, train_set, test_set, features) -> None:
        p = self.load_path
        if os.path.isfile(p) and p.endswith(".npy"):
            self.embedding = np.load(p)
        elif os.path.isfile(os.path.join(p, "emb.npy")):
            self.embedding = np.load(os.path.join(p, "emb.npy"))
        else:
            from gcn_song_embeddings_tpu_torch.data.graph import (
                load_feature_dir,
            )

            self.embedding = load_feature_dir(p, ids)
        if self.embedding.shape[0] != len(ids):
            raise ValueError(
                f"embedding rows {self.embedding.shape[0]} != ids {len(ids)}")
        self._table = torch.as_tensor(
            np.asarray(self.embedding, dtype=np.float32),
            device=resolve_device(self.device))

    def embed(self, nodeset):
        return self.embedding[np.asarray(nodeset)]

    def knn(self, nodeset, k):
        return knn_from_emb(self._table, np.asarray(nodeset), k)


class PersPageRank(PredictionModel):
    """PPR at query time: ``n_hops`` restart walks per query over the
    graph (co-listen augmented with ``colisten_copies`` > 0), ranked by
    visits, on ``device`` (default: the GPU, where the walks run K1)."""

    def __init__(self, n_hops: int = 1000, alpha: float = 0.85,
                 seed: int = 0, batch_size: int = 1024,
                 colisten_copies: int = 0, device=None):
        self.n_hops = n_hops
        self.alpha = alpha
        self.seed = seed
        self.batch_size = batch_size
        self.colisten_copies = colisten_copies
        self.device = device

    def train(self, graph, ids, train_set, test_set, features) -> None:
        dev = resolve_device(self.device)
        dg = DeviceGraph.from_graph(graph, dev)
        if self.colisten_copies > 0:
            dg = augment_with_colisten(dg, np.asarray(train_set),
                                       self.colisten_copies)
        self.tables = fused_walk_tables(dg)

    def uniforms(self, start: int, n_walkers: int) -> torch.Tensor:
        """The walk's uniforms [n_hops, n_walkers, 3] of the query block at
        ``start``."""
        dev = self.tables[0].device
        return draw_uniforms(self.n_hops, n_walkers,
                             block_generator(self.seed, start, dev))

    def knn(self, nodeset, k):
        nodeset = torch.as_tensor(np.asarray(nodeset, dtype=np.int32),
                                  device=self.tables[0].device)
        w_out, n_out = [], []
        for start in range(0, nodeset.shape[0], self.batch_size):
            block = nodeset[start:start + self.batch_size]
            w, n = sample_neighborhood_topt_tables(
                self.tables, block, self.n_hops, self.alpha, k,
                self.uniforms(start, block.shape[0]))
            w_out.append(w.cpu())
            n_out.append(n.cpu())
        return torch.cat(w_out).numpy(), torch.cat(n_out).numpy()
