"""Cosine-similarity top-k over an embedding table.

Ranking needs true f32 products: embeddings trained at a tiny margin
separate by ~1e-4 cosine, below TF32's resolution.  ``exact_f32`` turns
TF32 off for the products it wraps and restores the caller's setting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """Run f32 matrix products in full f32 (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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
