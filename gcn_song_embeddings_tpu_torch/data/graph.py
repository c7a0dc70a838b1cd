"""Graph data layer: JSON dataset -> int32 CSR arrays on the host.

Own copy of gcn_song_embeddings_tpu/data/graph.py.  The bipartite
song-playlist graph is stored as two int32 CSR adjacency structures

    item -> collections   (``i2c``, local collection ids)
    collection -> items   (``c2i``, local item ids)

which is what the 2-step random walk (item -> collection -> item)
consumes.  Integer ids are positions in ``list(tracks) ++
list(collections)`` with tracks in ``[0, n_items)``, so every artifact is
index-compatible with the JAX package's.

Edges are read by the native scanner (``native/jsongraph.py``), or by
the ``json`` module where it cannot run; ``SongGraph.edge_reader`` says
which.  Features come from one ``features.npy`` or from a directory of
per-track ``<id>.npy`` / ``<id>.pt`` files (the reference's layout), read
by the native threaded reader where it builds.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from gcn_song_embeddings_tpu_torch.native import featload, jsongraph


@dataclass
class CSR:
    """A compressed-sparse-row adjacency: ``indices[indptr[v]:indptr[v+1]]``."""

    indptr: np.ndarray   # int32 [n + 1]
    indices: np.ndarray  # int32 [nnz]

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)


def _build_csr(src: np.ndarray, dst: np.ndarray, n_src: int) -> CSR:
    """Deterministic CSR from an edge list, neighbor lists sorted by
    (src, dst) so two builds are bit-identical."""
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n_src).astype(np.int64)
    indptr = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr=indptr.astype(np.int32), indices=dst.astype(np.int32))


class SongGraph:
    """Bipartite song-playlist graph + per-track features + positive pairs.

    Built from a dataset dir in the reference format: ``tracks.json``,
    ``collections.json``, ``graph.json`` and ``positives*.json``, with
    features from a single ``features.npy`` (row order = ``list(tracks)``)
    or a directory of per-track files (``load_feature_dir``), z-normalized
    per dimension.  ``edge_reader`` names the reader that parsed
    ``graph.json``: ``"native"`` or ``"json"``.
    """

    def __init__(self, base_dir: str, features_dir: Optional[str] = None,
                 features_file: Optional[str] = None):
        self.base_dir = base_dir
        self.nbhds_path = os.path.join(base_dir, "neighborhoods.npz")

        with open(os.path.join(base_dir, "tracks.json"), encoding="utf-8") as f:
            self.tracks: dict = json.load(f)
        with open(os.path.join(base_dir, "collections.json"),
                  encoding="utf-8") as f:
            self.collections: dict = json.load(f)

        self.track_ids: list[str] = list(self.tracks)
        self.col_ids: list[str] = list(self.collections)
        self.n_items = len(self.track_ids)
        self.n_cols = len(self.col_ids)
        self.n_nodes = self.n_items + self.n_cols
        self.index_map = {nid: i for i, nid in
                          enumerate(self.track_ids + self.col_ids)}

        self._edges_from, self._edges_to, self.edge_reader = (
            jsongraph.load_edges(os.path.join(base_dir, "graph.json"),
                                 self.index_map))
        self.i2c, self.c2i = self._build_bipartite_csr()

        self.features: Optional[np.ndarray] = None
        if features_file is not None and os.path.isfile(features_file):
            self.features = z_normalize(
                np.load(features_file).astype(np.float32))
        elif features_dir is not None and os.path.isdir(features_dir):
            self.features = z_normalize(
                load_feature_dir(features_dir, self.track_ids))

    def _build_bipartite_csr(self) -> tuple[CSR, CSR]:
        src, dst = self._edges_from, self._edges_to
        n_items = self.n_items
        sel = src < n_items
        if not np.all(dst[sel] >= n_items):
            raise ValueError("graph is not bipartite: item->item edge found")
        i2c = _build_csr(src[sel], dst[sel] - n_items, n_items)
        selc = src >= n_items
        if not np.all(dst[selc] < n_items):
            raise ValueError("graph is not bipartite: col->col edge found")
        c2i = _build_csr(src[selc] - n_items, dst[selc], self.n_cols)
        return i2c, c2i

    def in_degrees(self, nodes: Optional[np.ndarray] = None) -> np.ndarray:
        """In-degree per node (== out-degree: graph.json holds both edge
        directions)."""
        deg = np.concatenate([self.i2c.degrees(), self.c2i.degrees()])
        if nodes is None:
            return deg
        return deg[np.asarray(nodes)]

    def song_info(self, index_id: int) -> str:
        info = self.tracks[self.track_ids[index_id]]
        return f"{info['name']} - {info['artist']}"

    def stats(self, positives: Optional[np.ndarray] = None) -> dict:
        """Node counts and song degrees, and with ``positives`` their
        count, distinct songs and co-occurrence statistics (the JAX
        package's keys)."""
        deg = self.i2c.degrees()
        out = {
            "n_nodes": self.n_nodes,
            "n_songs": self.n_items,
            "n_playlists": self.n_cols,
            "mean_song_degree": float(deg.mean()) if self.n_items else 0.0,
            "median_song_degree": (float(np.median(deg)) if self.n_items
                                   else 0.0),
        }
        if positives is not None:
            co = co_occurrence_counts(self.n_items, positives)
            out.update({
                "n_positives": int(positives.shape[0]),
                "unique_songs_in_positives": int(
                    np.unique(positives).shape[0]),
                "mean_co_occurrence": float(co.mean()),
                "median_co_occurrence": float(np.median(co)),
            })
        return out

    def load_positives(self, pos_path: str) -> np.ndarray:
        """[(a, b)] as an int32 [n, 2] array of track indices."""
        with open(pos_path, encoding="utf-8") as f:
            positives = json.load(f)
        track_map = {nid: i for i, nid in enumerate(self.track_ids)}
        out = np.empty((len(positives), 2), dtype=np.int32)
        for i, pair in enumerate(positives):
            out[i, 0] = track_map[pair["a"]]
            out[i, 1] = track_map[pair["b"]]
        return out

    def load_positives_split(self, pos_path: str, split: float = 0.7,
                             shuffle: bool = True, random_seed: int = 42
                             ) -> tuple[np.ndarray, np.ndarray]:
        """70/30 split shuffled with a fixed seed (the same split as the
        JAX package's)."""
        pos = self.load_positives(pos_path)
        n = pos.shape[0]
        if shuffle:
            index = np.random.RandomState(random_seed).permutation(n)
            pos = pos[index, :]
        cut = int(split * n)
        return pos[:cut], pos[cut:]


def z_normalize(features: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Per-dim z-norm with unbiased std + eps."""
    mean = features.mean(axis=0)
    std = features.std(axis=0, ddof=1) + eps
    return ((features - mean) / std).astype(np.float32)


def load_feature_dir(features_dir: str, track_ids: Sequence[str]
                     ) -> np.ndarray:
    """Stack per-id feature vectors [N, d] f32 (``<id>.npy`` preferred,
    ``<id>.pt`` read with ``torch.load(weights_only=True)``), through the
    native threaded reader where it builds, else one file at a time."""
    if featload.native_available():
        return featload.load_feature_rows(features_dir, track_ids)
    rows = []
    for tid in track_ids:
        npy = os.path.join(features_dir, tid + ".npy")
        pt = os.path.join(features_dir, tid + ".pt")
        if os.path.isfile(npy):
            # [1, d] row matrices are a valid layout: flatten as the
            # native reader does
            rows.append(np.load(npy).reshape(-1))
        elif os.path.isfile(pt):
            rows.append(featload.load_pt(pt))
        else:
            raise FileNotFoundError(f"no feature file for track {tid!r} in "
                                    f"{features_dir}")
    return np.stack(rows, axis=0).astype(np.float32)


def co_occurrence_counts(n_items: int, positives: np.ndarray) -> np.ndarray:
    """Count of (a, b) positive pairs per ``a``: the row sums of the
    track-track co-occurrence matrix."""
    return np.bincount(positives[:, 0], minlength=n_items).astype(np.int64)


def track_track_matrix(n_items: int, positives: np.ndarray):
    """Sparse track-track co-occurrence CSR: mat[a, b] = number of (a, b)
    positive pairs."""
    from scipy.sparse import coo_matrix

    data = np.ones(positives.shape[0], dtype=np.int32)
    mat = coo_matrix((data, (positives[:, 0], positives[:, 1])),
                     shape=(n_items, n_items))
    return mat.tocsr()


def col_track_matrix(graph: SongGraph):
    """Sparse collection x track membership CSR."""
    from scipy.sparse import csr_matrix

    c2i = graph.c2i
    data = np.ones(c2i.nnz, dtype=np.int32)
    return csr_matrix((data, c2i.indices, c2i.indptr),
                      shape=(graph.n_cols, graph.n_items))
