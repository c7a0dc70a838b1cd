"""Device-resident graph: the bipartite CSR arrays as int32 tensors.

This is what the walk kernel (K1) consumes.  The co-listen augmentation
runs on the host with numpy (it is an O(nnz) rebuild done once per
graph) and moves the result back to the graph's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph, _build_csr


@dataclass(frozen=True)
class DeviceGraph:
    """Bipartite song-playlist graph on one device.

    i2c_*: item -> collection adjacency (local collection ids)
    c2i_*: collection -> item adjacency (local item ids)
    """

    i2c_indptr: torch.Tensor   # [n_items + 1] int32
    i2c_indices: torch.Tensor  # [nnz] int32
    c2i_indptr: torch.Tensor   # [n_cols + 1] int32
    c2i_indices: torch.Tensor  # [nnz] int32

    @property
    def device(self) -> torch.device:
        return self.i2c_indptr.device

    @property
    def n_items(self) -> int:
        return self.i2c_indptr.shape[0] - 1

    @property
    def n_cols(self) -> int:
        return self.c2i_indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        """Directed edge count (both directions), like the reference graph."""
        return self.i2c_indices.shape[0] + self.c2i_indices.shape[0]

    @staticmethod
    def from_graph(graph: SongGraph, device: str | torch.device
                   ) -> "DeviceGraph":
        return DeviceGraph.from_arrays(graph.i2c.indptr, graph.i2c.indices,
                                       graph.c2i.indptr, graph.c2i.indices,
                                       device)

    @staticmethod
    def from_arrays(i2c_indptr, i2c_indices, c2i_indptr, c2i_indices,
                    device: str | torch.device) -> "DeviceGraph":
        def put(a):
            return torch.tensor(np.asarray(a, dtype=np.int32),
                                device=device)

        return DeviceGraph(put(i2c_indptr), put(i2c_indices),
                           put(c2i_indptr), put(c2i_indices))


def augment_with_colisten(graph: DeviceGraph, pairs: np.ndarray,
                          copies: int = 1) -> DeviceGraph:
    """Materialize co-listen pairs as 2-member pseudo-collections.

    Each train positive (a, b) becomes one new collection {a, b} appended
    after the real ones, so the item -> collection -> item walk also
    crosses co-listen links.  Duplicate pairs (and ``copies`` > 1) add
    edge multiplicity; self-pairs are dropped.  Same arrays as the JAX
    package's ``augment_with_colisten``.
    """
    if copies < 1:
        raise ValueError(f"copies must be >= 1, got {copies}")
    i2c_indptr = graph.i2c_indptr.cpu().numpy().astype(np.int64)
    i2c_indices = graph.i2c_indices.cpu().numpy().astype(np.int64)
    c2i_indptr = graph.c2i_indptr.cpu().numpy().astype(np.int64)
    c2i_indices = graph.c2i_indices.cpu().numpy().astype(np.int32)

    pairs = np.asarray(pairs, dtype=np.int64)[:, :2]
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    if copies > 1:
        pairs = np.repeat(pairs, copies, axis=0)
    m = pairs.shape[0]
    n_items, n_cols = graph.n_items, graph.n_cols

    # collection side: one fresh 2-member row per pair
    new_c2i_indptr = np.concatenate([
        c2i_indptr,
        c2i_indptr[-1] + 2 * np.arange(1, m + 1, dtype=np.int64)])
    new_c2i_indices = np.concatenate([c2i_indices,
                                      pairs.reshape(-1).astype(np.int32)])

    # item side: rebuild the CSR with the pair edges merged in
    old_src = np.repeat(np.arange(n_items, dtype=np.int64),
                        np.diff(i2c_indptr))
    new_cols = n_cols + np.arange(m, dtype=np.int64)
    src = np.concatenate([old_src, pairs.reshape(-1)])
    dst = np.concatenate([i2c_indices, np.repeat(new_cols, 2)])
    i2c = _build_csr(src, dst, n_items)
    return DeviceGraph.from_arrays(i2c.indptr, i2c.indices,
                                   new_c2i_indptr, new_c2i_indices,
                                   graph.device)


def apply_colisten_config(graph: DeviceGraph, positives: np.ndarray,
                          walk_cfg: WalkConfig, nbhds_path: str | None
                          ) -> tuple[DeviceGraph, str | None]:
    """Honor ``walk.colisten_copies``: returns the (possibly augmented)
    graph and the (possibly '.colistenN'-suffixed) neighborhoods cache
    path, named exactly as the JAX package names it so the two packages
    share one cache file."""
    if walk_cfg.colisten_copies <= 0:
        return graph, nbhds_path
    graph = augment_with_colisten(graph, positives,
                                  walk_cfg.colisten_copies)
    if nbhds_path is not None:
        root, ext = os.path.splitext(nbhds_path)
        d = WalkConfig()
        extra = ""
        if (walk_cfg.t_precompute, walk_cfg.n_hops) != (d.t_precompute,
                                                        d.n_hops):
            extra += f".T{walk_cfg.t_precompute}.h{walk_cfg.n_hops}"
        if walk_cfg.alpha != d.alpha:
            extra += f".a{walk_cfg.alpha:g}"
        if walk_cfg.parallel_chains != d.parallel_chains:
            extra += f".c{walk_cfg.parallel_chains}"
        nbhds_path = (f"{root}.colisten{walk_cfg.colisten_copies}"
                      f"{extra}{ext}")
    return graph, nbhds_path
