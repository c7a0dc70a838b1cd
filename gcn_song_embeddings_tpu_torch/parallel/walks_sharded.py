"""Edge-partitioned random walks: the graph's CSR sharded across ranks
(gcn_song_embeddings_tpu/parallel/walks_sharded.py on
``torch.distributed``).

``ops/walks.py`` keeps the whole bipartite CSR on one device.  Past one
device's memory the tables are edge-partitioned: each rank of the
``graph`` group owns a contiguous row range of the item->collection
table, of the collection->item table and of the flat neighbor arrays.
Walkers stay on their rank; every hop looks its neighbors up remotely
through the sharded table gather (``parallel/gather.py``): four gathers a
hop over the CSR tables (``make_sharded_walker``), two over the
extent-joined tables (``make_sharded_walker_fused``).

Randomness is an input: a walker takes its uniforms [hops, W, 3] f32 (the
same contract as ``ops.walks.walks_from_fused_tables``), so under the
same uniforms it replays the single-device walk, and the JAX package's
sharded walkers, bit for bit.  These walkers have no kernel in the JAX
package either: a hop is collectives plus ``uniform_slot`` in plain torch,
and the top-T step is ``ops.ppr.visit_counts_topt``.

Layout (row counts padded to multiples of the graph group's size):
    i2c_off  [n_items, 2] (start, degree), row-sharded
    i2c_idx  [nnz, 1]     neighbor ids, sharded by nnz ranges
    c2i_off / c2i_idx     likewise for the reverse direction
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.ops.walks import (
    _check_uniforms,
    chain_origins,
    draw_uniforms,
    uniform_slot,
)
from gcn_song_embeddings_tpu_torch.parallel import collectives as C
from gcn_song_embeddings_tpu_torch.parallel.gather import (
    sharded_table_gather,
)
from gcn_song_embeddings_tpu_torch.parallel.mesh import Mesh, pad_to_multiple


class ShardedGraph(NamedTuple):
    i2c_off: torch.Tensor   # local rows of [n_items_pad, 2] (start, deg)
    i2c_idx: torch.Tensor   # local rows of [nnz_pad, 1]
    c2i_off: torch.Tensor
    c2i_idx: torch.Tensor
    n_items: int
    n_cols: int


class ShardedFusedGraph(NamedTuple):
    """Extent-joined edge tables, sharded (``ops.walks.fused_walk_tables``):
    each edge row carries its target's (start, degree), so a two-step hop
    costs two collective gathers instead of four."""

    origin_ext: torch.Tensor  # local rows of [n_items_pad, 2]
    i2c_ext: torch.Tensor     # local rows of [nnz_pad, 2]
    c2i_ext: torch.Tensor     # local rows of [nnz_pad, 3]
    n_items: int
    n_cols: int


def _check_int32_extent(n_edges: int) -> None:
    """Edge offsets ride int32 gathers; past 2^31 they would wrap."""
    if n_edges >= np.iinfo(np.int32).max:
        raise ValueError(
            f"graph has {n_edges} directed edges, exceeding the int32 "
            f"offset range of the sharded walk tables; split the edge "
            f"arrays further or extend the tables to int64")


def _shard(arr: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of ``arr`` [n, c] padded to a multiple of g."""
    g, i = mesh.n_graph, mesh.graph_index
    arr = np.asarray(arr, dtype=np.int32)
    n_pad = pad_to_multiple(arr.shape[0], g)
    arr = np.pad(arr, ((0, n_pad - arr.shape[0]), (0, 0)))
    rows = n_pad // g
    return torch.as_tensor(arr[i * rows:(i + 1) * rows].copy(),
                           device=mesh.device)


def _host_csr(graph: DeviceGraph):
    return tuple(t.cpu().numpy().astype(np.int64) for t in (
        graph.i2c_indptr, graph.i2c_indices, graph.c2i_indptr,
        graph.c2i_indices))


def shard_graph(graph: DeviceGraph, mesh: Mesh) -> ShardedGraph:
    """Partition the bipartite CSR over the mesh's ``graph`` group."""
    i2c_ptr, i2c_idx, c2i_ptr, c2i_idx = _host_csr(graph)
    _check_int32_extent(max(len(i2c_idx), len(c2i_idx)))

    def offsets(ptr):
        return _shard(np.stack([ptr[:-1], np.diff(ptr)], axis=1), mesh)

    return ShardedGraph(
        i2c_off=offsets(i2c_ptr), i2c_idx=_shard(i2c_idx[:, None], mesh),
        c2i_off=offsets(c2i_ptr), c2i_idx=_shard(c2i_idx[:, None], mesh),
        n_items=graph.n_items, n_cols=graph.n_cols)


def shard_graph_fused(graph: DeviceGraph, mesh: Mesh) -> ShardedFusedGraph:
    """Partition the extent-joined edge tables over ``graph``."""
    i2c_ptr, cols, c2i_ptr, items = _host_csr(graph)
    _check_int32_extent(max(len(cols), len(items)))
    i2c_deg, c2i_deg = np.diff(i2c_ptr), np.diff(c2i_ptr)
    return ShardedFusedGraph(
        origin_ext=_shard(np.stack([i2c_ptr[:-1], i2c_deg], axis=1), mesh),
        i2c_ext=_shard(np.stack([c2i_ptr[cols], c2i_deg[cols]], axis=1),
                       mesh),
        c2i_ext=_shard(np.stack([items, i2c_ptr[items], i2c_deg[items]],
                                axis=1), mesh),
        n_items=graph.n_items, n_cols=graph.n_cols)


def _walker(start, step, alpha: float, n_hops: int, n_chains: int
            ) -> Callable:
    """walks(nodeset [W], uniforms [hops, W * n_chains, 3]) -> [W, n_hops]
    int32.  ``start(origins)`` is the state a restart returns to and
    ``step(state, u) -> (state, item)`` one hop; after each hop a walker
    restarts where ``u[:, 2] < alpha`` (an f32 compare, as in JAX)."""
    def walks(nodeset: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
        origins, hops = chain_origins(nodeset, n_hops, n_chains)
        _check_uniforms(uniforms, hops, origins.shape[0])
        alpha_f = torch.tensor(alpha, dtype=torch.float32,
                               device=uniforms.device)
        home = start(origins)
        cur, trace = home, []
        for u in uniforms:
            nxt, item = step(cur, u)
            trace.append(item)
            restart = (u[:, 2] < alpha_f).reshape(
                (-1,) + (1,) * (home.dim() - 1))
            cur = torch.where(restart, home, nxt)
        if not trace:
            return torch.empty((nodeset.shape[0], 0), dtype=torch.int32,
                               device=nodeset.device)
        return torch.stack(trace).t().reshape(nodeset.shape[0], n_hops)
    return walks


def make_sharded_walker(mesh: Mesh, sg: ShardedGraph, n_hops: int,
                        alpha: float, n_chains: int = 1) -> Callable:
    """walks(nodeset [W], uniforms) -> trace [W, n_hops] over the
    edge-partitioned CSR: four collective gathers a hop.  ``n_chains``
    splits each origin's hop budget into that many lockstep chains
    (``ops.walks.chain_origins``)."""
    group = mesh.graph_group

    def neighbor(off, idx, nodes, u):
        ext = sharded_table_gather(off, nodes, group)           # [W, 2]
        slot = ext[:, 0] + uniform_slot(u, ext[:, 1])
        return sharded_table_gather(idx, slot, group)[:, 0]

    def step(cur, u):
        col = neighbor(sg.i2c_off, sg.i2c_idx, cur, u[:, 0])
        item = neighbor(sg.c2i_off, sg.c2i_idx, col, u[:, 1])
        return item, item

    return _walker(lambda origins: origins, step, alpha, n_hops, n_chains)


def make_sharded_walker_fused(mesh: Mesh, sg: ShardedFusedGraph,
                              n_hops: int, alpha: float,
                              n_chains: int = 1) -> Callable:
    """Edge-partitioned walker over extent-joined tables: two collective
    gathers a hop, the same trace contract as ``make_sharded_walker``."""
    group = mesh.graph_group

    def start(origins):
        return sharded_table_gather(sg.origin_ext, origins, group)

    def step(cur, u):
        col = sharded_table_gather(
            sg.i2c_ext, cur[:, 0] + uniform_slot(u[:, 0], cur[:, 1]),
            group)                                               # [W, 2]
        row = sharded_table_gather(
            sg.c2i_ext, col[:, 0] + uniform_slot(u[:, 1], col[:, 1]),
            group)                                               # [W, 3]
        return row[:, 1:3], row[:, 0]

    return _walker(start, step, alpha, n_hops, n_chains)


def precompute_neighborhoods_partitioned(
        graph: DeviceGraph, cfg, mesh: Mesh, path: str | None = None,
        seed: int = 0, verbose: bool = False, uniforms=None
        ) -> tuple[np.ndarray, np.ndarray]:
    """All-node PPR sweep over an edge-partitioned graph.

    Every rank walks its share of each sweep block: blocks of
    ``batch_walkers`` origins padded to a multiple of the world size
    (ids wrap modulo the catalog), rank r taking slice r.  Its uniforms
    come from ``uniforms(start, rank, n_walkers)`` (default: a generator
    seeded from (seed, start, rank) on the rank's device).  The top-T of
    each slice is all-gathered; every rank returns the numpy (weights
    [N, T], nodes [N, T]) and rank 0 writes the cache (the
    ``ops.ppr`` layout and meta)."""
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        _save_cache,
        agreed_cache,
        effective_chains,
        seeded_generator,
        visit_counts_topt,
    )

    n_items, T, dev = graph.n_items, cfg.t_precompute, mesh.device
    cached = agreed_cache(path, n_items, T, cfg, seed, graph.n_edges, dev)
    if cached is not None:
        return cached
    chains = effective_chains(cfg.n_hops, cfg.parallel_chains)
    if cfg.fused_tables:
        walker = make_sharded_walker_fused(
            mesh, shard_graph_fused(graph, mesh), cfg.n_hops, cfg.alpha,
            n_chains=chains)
    else:
        walker = make_sharded_walker(mesh, shard_graph(graph, mesh),
                                     cfg.n_hops, cfg.alpha, n_chains=chains)
    if uniforms is None:
        def uniforms(start, rank, n_walkers):
            return draw_uniforms(cfg.n_hops // chains, n_walkers,
                                 seeded_generator([seed, start, rank], dev))
    sweep = pad_to_multiple(cfg.batch_walkers, mesh.n_dev)
    per_rank = sweep // mesh.n_dev
    all_w = np.zeros((n_items, T), dtype=np.float32)
    all_n = np.zeros((n_items, T), dtype=np.int32)
    for start in range(0, n_items, sweep):
        stop = min(start + sweep, n_items)
        first = start + mesh.rank * per_rank
        nodes = torch.arange(first, first + per_rank, dtype=torch.int32,
                             device=dev) % n_items
        trace = walker(nodes, uniforms(start, mesh.rank, per_rank * chains))
        w, n = visit_counts_topt(trace, nodes, T)
        all_w[start:stop] = C.all_gather(w).reshape(sweep, T)[
            :stop - start].cpu().numpy()
        all_n[start:stop] = C.all_gather(n).reshape(sweep, T)[
            :stop - start].cpu().numpy()
        if verbose:
            print(f"neighborhoods[partitioned]: {stop}/{n_items} done")
    if mesh.rank == 0:
        _save_cache(path, all_w, all_n, cfg, seed, graph.n_edges)
    dist.barrier()
    return all_w, all_n
