"""Graph data layer: JSON dataset -> int32 CSR arrays on the host.

Own copy of gcn_song_embeddings_tpu/data/graph.py.  The bipartite
song-playlist graph is stored as two int32 CSR adjacency structures

    item -> collections   (``i2c``, local collection ids)
    collection -> items   (``c2i``, local item ids)

which is what the 2-step random walk (item -> collection -> item)
consumes.  Integer ids are positions in ``list(tracks) ++
list(collections)`` with tracks in ``[0, n_items)``, so every artifact is
index-compatible with the JAX package's.

Edges are read with the standard ``json`` module (the JAX package's
native scanner is not part of the port yet).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


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


def _load_edges(graph_path: str, index_map: dict[str, int]
                ) -> tuple[np.ndarray, np.ndarray]:
    """graph.json -> (from_idx, to_idx) int32 arrays."""
    with open(graph_path, encoding="utf-8") as f:
        edges = json.load(f)["edges"]
    src = np.fromiter((index_map[e["from"]] for e in edges),
                      dtype=np.int32, count=len(edges))
    dst = np.fromiter((index_map[e["to"]] for e in edges),
                      dtype=np.int32, count=len(edges))
    return src, dst


class SongGraph:
    """Bipartite song-playlist graph + per-track features + positive pairs.

    Built from a dataset dir in the reference format: ``tracks.json``,
    ``collections.json``, ``graph.json`` and ``positives*.json``, with
    features from a single ``features.npy`` (row order = ``list(tracks)``),
    z-normalized per dimension.
    """

    def __init__(self, base_dir: str, features_file: Optional[str] = None):
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

        self._edges_from, self._edges_to = _load_edges(
            os.path.join(base_dir, "graph.json"), self.index_map)
        self.i2c, self.c2i = self._build_bipartite_csr()

        self.features: Optional[np.ndarray] = None
        if features_file is not None and os.path.isfile(features_file):
            self.features = z_normalize(
                np.load(features_file).astype(np.float32))

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
