"""Offline evaluation metrics over kNN lists (own copy of
gcn_song_embeddings_tpu/evals/metrics.py).

Numpy, and equal to the JAX package's, quirks included:
  * ``mrr`` counts a miss as rank K;
  * ``coverage`` looks at kNN columns 1:K+1;
  * ``inter_diversity`` is the mean cosine DISTANCE between one-hot rec
    sets of query pairs drawn from ``RandomState(seed)`` (the same pairs).

``intra_diversity`` is O(N * K^2 * d), ~10^12 operations a model at 100k
queries, K = 100, d = 512: with a ``device`` it runs its batched product
in torch there (f32, TF32 off) instead of host numpy.
"""

from __future__ import annotations

import numpy as np


def _rank_of_positive(knn_mat: np.ndarray, test_positives: np.ndarray,
                      K: int) -> np.ndarray:
    """1-based rank of each pair's positive in the query's top-K,
    K if missing (the reference's miss fallback, eval.py:248-249)."""
    rows = knn_mat[test_positives[:, 0], :K]          # [n, K]
    hit = rows == test_positives[:, 1][:, None]       # [n, K]
    any_hit = hit.any(axis=1)
    first = hit.argmax(axis=1) + 1                    # 1-based
    return np.where(any_hit, first, K)


def hit_rate(knn_mat: np.ndarray, test_positives: np.ndarray, K: int) -> float:
    """Fraction of test pairs whose positive appears in the query's top-K
    (eval.py:227-238)."""
    if len(test_positives) == 0:
        return 0.0
    rows = knn_mat[test_positives[:, 0], :K]
    return float((rows == test_positives[:, 1][:, None]).any(axis=1).mean())


def mrr(knn_mat: np.ndarray, test_positives: np.ndarray, K: int,
        scaling: float = 1.0) -> float:
    """Mean reciprocal rank with rank=K fallback for misses
    (eval.py:240-250)."""
    if len(test_positives) == 0:
        return 0.0
    ranks = _rank_of_positive(knn_mat, test_positives, K)
    return float(np.mean(scaling / ranks))


def intra_diversity(knn_mat: np.ndarray, test_positives, K: int,
                    features: np.ndarray, batch: int = 256,
                    device=None) -> float:
    """1 - mean pairwise feature cosine similarity within each top-K list
    (eval.py:271-286).  Includes the diagonal, like the reference.  With a
    ``device`` the batched product runs in torch there."""
    n = knn_mat.shape[0]
    feats = np.asarray(features, dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    unit = feats / np.maximum(norms, 1e-10)
    if device is not None:
        return _intra_diversity_torch(knn_mat, K, unit, batch, device)
    total = 0.0
    for start in range(0, n, batch):
        rec = knn_mat[start:start + batch, :K].astype(np.int64)  # [b, K]
        rf = unit[rec]                                           # [b, K, d]
        sims = np.einsum("bkd,bld->bkl", rf, rf)
        total += sims.mean(axis=(1, 2)).sum()
    return 1.0 - total / n


def _intra_diversity_torch(knn_mat, K: int, unit: np.ndarray, batch: int,
                           device) -> float:
    import torch

    from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32

    n = knn_mat.shape[0]
    unit_d = torch.as_tensor(unit, device=device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    with exact_f32():
        for start in range(0, n, batch):
            rec = torch.as_tensor(
                np.asarray(knn_mat[start:start + batch, :K], np.int64),
                device=device)
            rf = unit_d[rec]                                     # [b, K, d]
            sims = torch.bmm(rf, rf.transpose(1, 2))             # [b, K, K]
            total += sims.mean(dim=(1, 2)).sum().double()
    return 1.0 - float(total) / n


def inter_diversity(knn_mat: np.ndarray, test_positives=None, K: int = 100,
                    n_pairs: int = 10000, seed: int = 0) -> float:
    """Mean cosine distance between the one-hot top-K rec sets of random
    query pairs (eval.py:288-312).  For K-sized distinct rec lists the
    cosine similarity is |intersection| / K.

    All n_pairs row intersections are computed in ONE searchsorted by
    lifting each sorted row into its own disjoint value range (row r
    shifted by r * stride), which keeps the concatenation globally sorted.
    """
    n = knn_mat.shape[0]
    K = min(K, knn_mat.shape[1])
    rng = np.random.RandomState(seed)
    pairs = rng.randint(0, n, (n_pairs, 2))
    a = np.sort(knn_mat[pairs[:, 0], :K].astype(np.int64), axis=1)
    b = np.sort(knn_mat[pairs[:, 1], :K].astype(np.int64), axis=1)
    stride = np.int64(max(int(a.max()), int(b.max())) + 1)
    off = np.arange(n_pairs, dtype=np.int64)[:, None] * stride
    flat_a = (a + off).ravel()
    flat_b = (b + off).ravel()
    pos = np.clip(np.searchsorted(flat_a, flat_b), 0, flat_a.size - 1)
    inter = (flat_a[pos] == flat_b).reshape(n_pairs, K).sum(axis=1)
    sim = inter / K
    return float(np.mean(1.0 - sim))


def coverage(knn_mat: np.ndarray, test_positives=None, K: int = 500,
             all_nodes: bool = True) -> float:
    """Catalog coverage of recommendations: unique nodes in kNN columns
    1:K+1 over all queries (eval.py:342-355, including the 1:K+1 quirk)."""
    if all_nodes or test_positives is None:
        recs = knn_mat[:, 1:K + 1].reshape(-1)
    else:
        recs = np.asarray(test_positives).reshape(-1)
    return float(np.unique(recs).shape[0] / knn_mat.shape[0])


def average_degree(knn_mat: np.ndarray, in_degrees: np.ndarray,
                   test_positives=None, K: int = 100) -> float:
    """Mean in-degree of recommended nodes = novelty proxy
    (eval.py:357-364).  `in_degrees` is a [n_nodes] vector (the reference
    passes the graph and calls g.in_degrees)."""
    recs = knn_mat[:, :K].reshape(-1).astype(np.int64)
    return float(np.mean(in_degrees[recs].astype(np.float64)))


def degree_dist(knn_mat: np.ndarray, in_degrees: np.ndarray, K: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Degree distribution (levels, counts) over recommendations
    (eval.py:366-374)."""
    recs = knn_mat[:, :K].reshape(-1).astype(np.int64)
    return np.unique(in_degrees[recs], return_counts=True)


def low_degree_accuracy(knn_mat: np.ndarray, in_degrees: np.ndarray,
                        test_positives: np.ndarray, K: int, degree_thr: int,
                        acc_func) -> float:
    """Accuracy restricted to test pairs whose query has in-degree <= thr
    (eval.py:376-389)."""
    sel = in_degrees[test_positives[:, 0]] <= degree_thr
    if not sel.any():
        return 0.0
    return acc_func(knn_mat, test_positives[sel], K)


def low_co_accuracy(knn_mat: np.ndarray, test_positives: np.ndarray, K: int,
                    co_thr: int, acc_func) -> float:
    """Accuracy restricted to queries with <= co_thr track-track
    co-occurrences in the TEST positives (eval.py:391-406 builds the
    co-occurrence matrix from the positives passed in)."""
    n = knn_mat.shape[0]
    co = np.bincount(test_positives[:, 0], minlength=n)
    sel = co[test_positives[:, 0]] <= co_thr
    if not sel.any():
        return 0.0
    return acc_func(knn_mat, test_positives[sel], K)
