"""Cosine-similarity top-k over an embedding table.

Ranking needs true f32 products: embeddings trained at a tiny margin
separate by ~1e-4 cosine, below TF32's resolution.  ``exact_f32`` turns
TF32 off for the matrix products and cuDNN convolutions it wraps and
restores the caller's settings.
These are plain products and ``torch.topk`` (the JAX package computes
them in XLA, not in a Pallas kernel).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def exact_f32():
    """Run f32 matrix products and convolutions in full f32 (TF32 off)
    inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def cosine_topk_block(emb: torch.Tensor, queries: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-(k+1) cosine neighbors of the query rows with column 0 (self)
    dropped: emb [N, d], queries [B] -> (weights [B, k], nodes [B, k]).
    Order among equal scores may differ from JAX's ``lax.top_k``."""
    q = emb[queries.long()]
    with exact_f32():
        dot = q @ emb.t()
    q_len = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    e_len = torch.linalg.vector_norm(emb, dim=1)[None, :]
    sim = dot / (q_len * e_len + 1e-16)
    w, n = torch.topk(sim, k + 1, dim=1)
    return w[:, 1:], n[:, 1:].to(torch.int32)


def cosine_topk_streamed(emb: torch.Tensor, queries: torch.Tensor, k: int,
                         chunk: int = 8192
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_block`` with the table read in [chunk, d] tiles: a
    running top-(k+1) is merged with each tile's top-k, so memory is
    O(B * (chunk + k)) whatever N is."""
    kk = k + 1
    q = emb[queries.long()]
    q_len = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    e_len = torch.linalg.vector_norm(emb, dim=1)
    best_w = torch.full((q.shape[0], 0), float("-inf"), device=emb.device)
    best_n = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                         device=emb.device)
    for start in range(0, emb.shape[0], chunk):
        rows = emb[start:start + chunk]
        with exact_f32():
            sim = q @ rows.t()
        sim = sim / (q_len * e_len[None, start:start + chunk] + 1e-16)
        w, idx = torch.topk(sim, min(kk, rows.shape[0]), dim=1)
        cand_w = torch.cat([best_w, w], dim=1)
        cand_n = torch.cat([best_n, idx + start], dim=1)
        best_w, pos = torch.topk(cand_w, min(kk, cand_w.shape[1]), dim=1)
        best_n = torch.gather(cand_n, 1, pos)
    return best_w[:, 1:], best_n[:, 1:].to(torch.int32)


def knn_from_emb(emb, queries=None, k: int = 1000,
                 batch_size: int | None = None,
                 streamed: bool | None = None, chunk: int = 8192,
                 device=None) -> tuple[np.ndarray, np.ndarray]:
    """The kNN sweep over ``queries`` (default: every row) in query
    blocks -> numpy (weights [Nq, k] f32, nodes [Nq, k] int32), self
    dropped, k clamped to N - 1.

    ``streamed=None`` picks the streamed tiles past 100,000 rows, as the
    JAX package does; the default block is 512 queries dense, 2048
    streamed.  ``emb`` is a tensor (used on its device) or an array put on
    ``device`` (default: the GPU)."""
    if not isinstance(emb, torch.Tensor):
        emb = torch.as_tensor(np.asarray(emb, dtype=np.float32),
                              device=resolve_device(device))
    emb = emb.to(torch.float32)
    n = emb.shape[0]
    if queries is None:
        queries = np.arange(n, dtype=np.int64)
    queries = torch.as_tensor(np.asarray(queries, dtype=np.int64),
                              device=emb.device)
    k = min(k, n - 1)
    if streamed is None:
        streamed = n > 100_000
    if batch_size is None:
        batch_size = 2048 if streamed else 512
    w_out, n_out = [], []
    for start in range(0, queries.shape[0], batch_size):
        block = queries[start:start + batch_size]
        if streamed:
            w, nn = cosine_topk_streamed(emb, block, k, chunk)
        else:
            w, nn = cosine_topk_block(emb, block, k)
        w_out.append(w.cpu())
        n_out.append(nn.cpu())
    if not w_out:
        return (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
    return torch.cat(w_out).numpy(), torch.cat(n_out).numpy()
