"""Simple baselines: Random, EmbLoader, PersPageRank, WalkEmbedHybrid and
JaccardFast (own copy of gcn_song_embeddings_tpu/models/baselines/simple.py).

``Random`` draws from numpy exactly as the JAX package does, so its lists
are equal.  ``EmbLoader`` serves a saved embedding matrix through the
cosine kNN sweep on its device.  ``PersPageRank`` walks at query time
(kernel K1 on the GPU) and ranks the visits; its uniforms come from a
generator per query block, keyed on (seed, block start) as the sweep's
``block_generator``, where the JAX package folds the block start into a
threefry key.  ``WalkEmbedHybrid`` puts a PersPageRank walk head in
front of the embedding's cosine ranking (``ops.merge.merge_topk``);
``JaccardFast`` scores playlist-membership Jaccard on the device.
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
from gcn_song_embeddings_tpu_torch.data.graph import col_track_matrix
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.ops.merge import merge_topk
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


class WalkEmbedHybrid(PredictionModel):
    """Walk precision + embedding recall: each top-k list starts with the
    walk head's nonzero-visit neighbors (``PersPageRank`` over the
    co-listen augmented graph, K1 on the GPU) in walk order, completed by
    the embedding's cosine ranking without the items already placed
    (``ops.merge.merge_topk``, on the device).

    ``emb_source`` is an embedding matrix, an ``emb.npy`` path or a run
    directory (``EmbLoader``)."""

    def __init__(self, emb_source, n_hops: int = 1000, alpha: float = 0.85,
                 seed: int = 0, batch_size: int = 1024,
                 colisten_copies: int = 1, device=None):
        self.walker = PersPageRank(n_hops=n_hops, alpha=alpha, seed=seed,
                                   batch_size=batch_size,
                                   colisten_copies=colisten_copies,
                                   device=device)
        self.emb_source = emb_source
        self.device = device

    def train(self, graph, ids, train_set, test_set, features) -> None:
        self.walker.train(graph, ids, train_set, test_set, features)
        if isinstance(self.emb_source, np.ndarray):
            self.embedding = self.emb_source
            self._table = torch.as_tensor(
                np.asarray(self.embedding, dtype=np.float32),
                device=resolve_device(self.device))
        else:
            loader = EmbLoader(self.emb_source, device=self.device)
            loader.train(graph, ids, train_set, test_set, features)
            self.embedding, self._table = loader.embedding, loader._table

    def knn(self, nodeset, k):
        walk_w, walk_n = self.walker.knn(nodeset, k)
        emb_w, emb_n = knn_from_emb(self._table, np.asarray(nodeset), k)
        dev = self._table.device
        w, n = merge_topk(*(torch.as_tensor(a, device=dev)
                            for a in (walk_w, walk_n, emb_w, emb_n)))
        return w.cpu().numpy(), n.cpu().numpy()


def merge_ranked_lists(head_w: np.ndarray, head_n: np.ndarray,
                       tail_w: np.ndarray, tail_n: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """The readable numpy oracle of ``ops.merge.merge_topk``: per row, the
    head entries with weight > 0 in order (weights shifted above every
    tail weight), then the tail entries not already present; the output
    is max(head_k, tail_k) wide, short rows filled with the last placed
    node at weight -inf."""
    B, head_k = head_n.shape
    tail_k = tail_n.shape[1]
    k = max(head_k, tail_k)
    out_w = np.full((B, k), -np.inf, dtype=np.float32)
    out_n = np.empty((B, k), dtype=np.int32)
    shift = float(np.abs(tail_w).max()) + 1.0 if tail_w.size else 1.0
    for i in range(B):
        keep = head_w[i] > 0
        h_n = head_n[i][keep]
        seen = set(h_n.tolist())
        t_mask = np.fromiter((n not in seen for n in tail_n[i]),
                             count=tail_k, dtype=bool)
        t_n = tail_n[i][t_mask][: k - len(h_n)]
        t_w = tail_w[i][t_mask][: k - len(h_n)]
        out_n[i, :len(h_n)] = h_n
        out_w[i, :len(h_n)] = head_w[i][keep] + shift
        out_n[i, len(h_n):len(h_n) + len(t_n)] = t_n
        out_w[i, len(h_n):len(h_n) + len(t_n)] = t_w
        fill = len(h_n) + len(t_n)
        if fill < k:                       # degenerate tiny catalogs
            out_n[i, fill:] = t_n[-1] if len(t_n) else h_n[-1]
    return out_w, out_n


class JaccardFast(PredictionModel):
    """Jaccard similarity over playlist membership: intersections ``C^T
    C`` by one host SpGEMM (scipy) at ``train``; at ``knn`` the query rows
    go to ``device`` (default: the GPU) as their nonzeros, where
    |union| = deg_a + deg_b - |intersection|, the f32 scores and their
    top-k are computed.

    Keeps the reference's shape quirk: top-k, then column 0 dropped (self
    is assumed to rank first), so the lists are k-1 wide."""

    def __init__(self, device=None):
        self.device = device

    def train(self, graph, ids, train_set, test_set, features) -> None:
        ct = col_track_matrix(graph)                     # [C, N] 0/1
        inter = (ct.T @ ct).tocsr()                      # [N, N] SpGEMM
        self.intersections = inter
        self.nbh_sizes = np.asarray(inter.diagonal()).ravel()
        self._dev = resolve_device(self.device)
        self._sizes = torch.as_tensor(self.nbh_sizes.astype(np.float32),
                                      device=self._dev)

    def knn(self, nodeset, k):
        nodeset = np.asarray(nodeset, dtype=np.int64)
        rows = self.intersections[nodeset, :].tocoo()
        inter = torch.zeros(rows.shape, dtype=torch.float32,
                            device=self._dev)
        inter[torch.as_tensor(rows.row, device=self._dev),
              torch.as_tensor(rows.col, device=self._dev)] = torch.as_tensor(
                  rows.data.astype(np.float32), device=self._dev)
        deg_a = self._sizes[torch.as_tensor(nodeset, device=self._dev)]
        union = deg_a[:, None] + self._sizes[None, :] - inter
        scores = inter / (union + 1e-10)
        w, n = torch.topk(scores, k, dim=1)
        return w[:, 1:].cpu().numpy(), n[:, 1:].to(torch.int32).cpu().numpy()
