"""Node2Vec baseline: biased walks + skip-gram with negative sampling (own
copy of gcn_song_embeddings_tpu/models/baselines/node2vec.py), in plain
PyTorch on a device (default: the GPU).

The reference's hyperparameters (dim 128, walk length 20, context 10,
p 2, q 0.5, 10 epochs) over the weighted track-track projection; the
walks come from ``ops.node2vec`` and skip-gram trains by SGD steps whose
scatter-adds sum duplicate ids (``index_add_``).  The initial ``W_in``
and each step's draws are inputs, so the JAX package's can be fed in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.models.baselines.base import (
    EmbeddingModel,
)
from gcn_song_embeddings_tpu_torch.ops.graph_ops import project_bipartite
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.ops.node2vec import (
    build_alias_graph,
    draw_walks,
    node2vec_walks,
)
from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

REJECTION_ROUNDS = 3  # the p/q rejection rounds of each walk step


class SkipgramDraws(NamedTuple):
    """One step's draws for a batch of B pairs: walk rows, center
    positions, context offsets in [1, context], the uniforms that pick
    the offset's sign (< 0.5: backwards) and [B, negatives] negative
    node ids."""

    rows: torch.Tensor
    pos: torch.Tensor
    off: torch.Tensor
    sign_u: torch.Tensor
    negs: torch.Tensor


def skipgram_steps(n_walks: int, walk_len: int, context: int, epochs: int,
                   batch: int) -> int:
    """Steps of ``batch`` pairs for one pair per window slot per epoch."""
    return max(n_walks * walk_len * context * epochs // batch, 1)


def train_skipgram(walks: torch.Tensor, n_nodes: int, dim: int = 128,
                   context: int = 10, negatives: int = 5, epochs: int = 10,
                   batch: int = 8192, lr0: float = 0.025,
                   lr_min: float = 1e-4, seed: int = 0,
                   W_in: torch.Tensor | None = None,
                   draws=None) -> np.ndarray:
    """Skip-gram with negative sampling over the walks (on their device)
    -> W_in [n_nodes, dim] as numpy.

    Each step samples ``batch`` (center, context) pairs uniformly (walk
    row, position, offset within +-context, clipped to the walk) and
    uniform negatives; the rate decays linearly from lr0 to lr_min.
    ``W_in`` (default: uniform in [-0.5, 0.5) / dim) and ``draws(step)``
    -> ``SkipgramDraws`` (default: a generator seeded from ``seed``) carry
    the randomness."""
    dev = walks.device
    n_walks, walk_len = walks.shape
    walks = walks.long()
    gen = seeded_generator([seed], dev)
    if W_in is None:
        W_in = (torch.rand((n_nodes, dim), generator=gen, device=dev)
                - 0.5) / dim
    W_in = W_in.to(device=dev, dtype=torch.float32).clone()
    W_out = torch.zeros((n_nodes, dim), dtype=torch.float32, device=dev)
    if draws is None:
        def draws(step):
            def ints(lo, hi, size):
                return torch.randint(lo, hi, size, generator=gen,
                                     device=dev)
            return SkipgramDraws(
                ints(0, n_walks, (batch,)), ints(0, walk_len, (batch,)),
                ints(1, context + 1, (batch,)),
                torch.rand((batch,), generator=gen, device=dev),
                ints(0, n_nodes, (batch, negatives)))

    n_steps = skipgram_steps(n_walks, walk_len, context, epochs, batch)
    fracs = np.linspace(0.0, 1.0, n_steps, dtype=np.float32)
    for step in range(n_steps):
        d = draws(step)
        frac = float(fracs[step])
        lr = lr0 * (1 - frac) + lr_min * frac
        rows = d.rows.long()
        sign = torch.where(d.sign_u < 0.5, -1, 1)
        ctx_pos = torch.clamp(d.pos.long() + d.off.long() * sign, 0,
                              walk_len - 1)
        center = walks[rows, d.pos.long()]
        ctx = walks[rows, ctx_pos]
        negs = d.negs.long()

        v = W_in[center]                              # [B, d]
        u_pos = W_out[ctx]                            # [B, d]
        u_neg = W_out[negs]                           # [B, neg, d]
        s_pos = torch.sum(v * u_pos, dim=1)
        s_neg = torch.sum(v[:, None, :] * u_neg, dim=2)
        g_pos = torch.sigmoid(s_pos) - 1.0            # dL/ds_pos
        g_neg = torch.sigmoid(s_neg)                  # dL/ds_neg
        grad_v = g_pos[:, None] * u_pos + torch.sum(
            g_neg[:, :, None] * u_neg, dim=1)
        W_in.index_add_(0, center, -lr * grad_v)
        W_out.index_add_(0, ctx, -lr * g_pos[:, None] * v)
        W_out.index_add_(0, negs.reshape(-1),
                         (-lr * g_neg[:, :, None] * v[:, None, :]
                          ).reshape(-1, dim))
    return W_in.cpu().numpy()


class FastNode2Vec(EmbeddingModel):
    """node2vec on the weighted track-track projection, on ``device``.

    ``walk_draws(n_walks, device)`` gives the walks' ``WalkDraws``
    (default: a generator seeded from ``seed``); ``alias`` keeps the
    projection's alias graph after ``train``."""

    def __init__(self, dim: int = 128, walk_length: int = 20,
                 context: int = 10, p: float = 2.0, q: float = 0.5,
                 epochs: int = 10, walks_per_node: int = 10, seed: int = 0,
                 device=None):
        self.dim = dim
        self.walk_length = walk_length
        self.context = context
        self.p = p
        self.q = q
        self.epochs = epochs
        self.walks_per_node = walks_per_node
        self.seed = seed
        self.device = device
        self.embedding: np.ndarray | None = None

    def walk_draws(self, n_walks: int, dev):
        return draw_walks(n_walks, self.walk_length, REJECTION_ROUNDS,
                          seeded_generator([self.seed, 1], dev))

    def train(self, graph, ids, train_set, test_set, features) -> None:
        dev = resolve_device(self.device)
        n = len(ids)
        proj = project_bipartite(graph)
        self.alias = build_alias_graph(proj.indptr, proj.indices,
                                       proj.data.astype(np.float64),
                                       device=dev)
        starts = torch.arange(n, device=dev).repeat(self.walks_per_node)
        walks = node2vec_walks(self.alias, starts, self.walk_length, self.p,
                               self.q, self.walk_draws(len(starts), dev))
        self.embedding = train_skipgram(
            walks, n, dim=self.dim, context=self.context,
            epochs=self.epochs, seed=self.seed)
        self._table = torch.as_tensor(self.embedding, device=dev)

    def embed(self, nodeset):
        return self.embedding[np.asarray(nodeset)]

    def knn(self, nodeset, k):
        return knn_from_emb(self._table, np.asarray(nodeset), k)
