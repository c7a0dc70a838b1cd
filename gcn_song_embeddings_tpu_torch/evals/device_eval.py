"""Accuracy straight from the embedding table, with no kNN lists.

The rank of pair (q, pos) among all candidates is

    rank = 1 + #{j != q : sim(q, j) > sim(q, pos)} + #{tied j != pos} / 2

(AVERAGE rank over score ties within ``TIE_EPS``: a duplicate row must
not rank optimistically), one product row and one comparison per pair.
The catalog is scanned in [chunk, d] tiles, so no [B, N] block is
materialized; the half-rank is summed in integers and the rank formed in
f32, as the JAX package's ``evals/device_eval.py`` does.  hit@K is
rank <= K; MRR caps the rank at its K (a miss counts as rank K).
"""

from __future__ import annotations

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

# pos_sim is an elementwise reduction and the candidates' sims come from a
# matrix product: they may differ by ~1 ulp, so exact equality would miss
# the ties of duplicate rows.  1e-6 on the cosine scale stays ~100x below
# the separations of tiny-margin embeddings (~1e-4).
TIE_EPS = 1e-6


def pair_ranks(unit: torch.Tensor, q: torch.Tensor, pos: torch.Tensor,
               chunk: int = 65536) -> torch.Tensor:
    """1-based average rank [B] f32 of ``pos`` among the non-self
    candidates of ``q``; ``unit`` [N, d] holds L2-normalized rows."""
    n = unit.shape[0]
    q, pos = q.long(), pos.long()
    qv = unit[q]
    pos_sim = (qv * unit[pos]).sum(dim=1)[:, None]
    acc = torch.zeros(q.shape[0], dtype=torch.int64, device=unit.device)
    for start in range(0, n, chunk):
        rows = unit[start:start + chunk]
        with exact_f32():
            sims = qv @ rows.t()
        idx = torch.arange(start, start + rows.shape[0],
                           device=unit.device)[None, :]
        not_self = idx != q[:, None]
        better = (sims > pos_sim + TIE_EPS) & not_self
        tied = ((sims - pos_sim).abs() <= TIE_EPS) & not_self & (
            idx != pos[:, None])
        acc += 2 * better.sum(dim=1) + tied.sum(dim=1)
    return 1.0 + acc.to(torch.float32) * 0.5


def unit_rows(embeddings) -> np.ndarray:
    """Rows scaled to unit length (a zero row stays zero), in f32."""
    emb = np.asarray(embeddings, dtype=np.float32)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norms, 1e-12)


def rank_eval(embeddings, test_pairs: np.ndarray,
              hit_ks: tuple[int, ...] = (10, 100, 500), mrr_k: int = 1000,
              batch: int = 2048, chunk: int = 65536, device=None
              ) -> dict[str, float]:
    """hit@K and MRR@mrr_k of (query, positive) pairs against the full
    catalog, straight from the embedding matrix, on ``device`` (default:
    the GPU)."""
    dev = resolve_device(device)
    unit = torch.as_tensor(unit_rows(embeddings), device=dev)
    pairs = torch.as_tensor(np.asarray(test_pairs, dtype=np.int64),
                            device=dev).reshape(-1, 2)
    ranks = np.concatenate([np.empty(0)] + [
        pair_ranks(unit, pairs[s:s + batch, 0], pairs[s:s + batch, 1],
                   chunk).cpu().numpy().astype(np.float64)
        for s in range(0, pairs.shape[0], batch)])
    out = {f"hit@{k}": float((ranks <= k).mean()) for k in hit_ks}
    out[f"mrr@{mrr_k}"] = float((1.0 / np.minimum(ranks, mrr_k)).mean())
    return out
