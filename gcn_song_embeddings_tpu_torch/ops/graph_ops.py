"""Host graph algebra: the bipartite projection and link-prediction scores
(own copy of gcn_song_embeddings_tpu/ops/graph_ops.py).

  * ``project_bipartite``: the weighted track-track projection of the
    playlist-track graph (weight = number of shared playlists, diagonal
    dropped), one SpGEMM ``C^T C``.
  * Preferential attachment, Adamic-Adar and Jaccard scores of query
    rows against every node, as sparse products and degree algebra.

Everything here is scipy/numpy on the host; its outputs equal the JAX
package's bit for bit.  The recommenders rank the scores on a device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from gcn_song_embeddings_tpu_torch.data.graph import col_track_matrix


def project_bipartite(graph) -> sp.csr_matrix:
    """Weighted track-track projection: W[a, b] = #playlists holding both
    a and b (a != b).  ``graph`` is a SongGraph."""
    ct = col_track_matrix(graph).astype(np.float32)  # [C, N]
    w = (ct.T @ ct).tocsr()
    w.setdiag(0)
    w.eliminate_zeros()
    return w


def adjacency_tracks(graph, projected: bool = True) -> sp.csr_matrix:
    """Track-side adjacency: the weighted projection, or the bipartite
    adjacency's track rows (track x collection)."""
    if projected:
        return project_bipartite(graph)
    return col_track_matrix(graph).astype(np.float32).T.tocsr()


def preferential_scores(adj: sp.csr_matrix, queries: np.ndarray
                        ) -> np.ndarray:
    """Preferential attachment: deg(q) * deg(v) on the unweighted graph."""
    deg = np.asarray((adj > 0).sum(axis=1)).ravel().astype(np.float32)
    return deg[queries][:, None] * deg[None, :]


def common_neighbor_matrix(adj: sp.csr_matrix, queries: np.ndarray,
                           weights: np.ndarray | None = None) -> np.ndarray:
    """[q, N] (optionally weighted) common-neighbor counts."""
    a = (adj > 0).astype(np.float32)
    rows = a[queries]
    if weights is not None:
        rows = rows.multiply(weights[None, :]).tocsr()
    return np.asarray((rows @ a.T).todense(), dtype=np.float32)


def adamic_adar_scores(adj: sp.csr_matrix, queries: np.ndarray) -> np.ndarray:
    """Adamic-Adar: the sum over common neighbors z of 1/log(deg(z)); z
    ranges over adj's columns, so deg(z) is a column sum."""
    col_deg = np.asarray((adj > 0).sum(axis=0)).ravel().astype(np.float32)
    inv_log = np.zeros_like(col_deg)
    ok = col_deg > 1
    inv_log[ok] = 1.0 / np.log(col_deg[ok])
    return common_neighbor_matrix(adj, queries, weights=inv_log)


def jaccard_scores(adj: sp.csr_matrix, queries: np.ndarray) -> np.ndarray:
    """Jaccard index: |N(q) ∩ N(v)| / |N(q) ∪ N(v)|."""
    deg = np.asarray((adj > 0).sum(axis=1)).ravel().astype(np.float32)
    inter = common_neighbor_matrix(adj, queries)
    union = deg[queries][:, None] + deg[None, :] - inter
    return inter / np.maximum(union, 1e-10)
