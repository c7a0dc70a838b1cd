"""PPR visit counts, top-T neighborhood selection and the all-node sweep.

weight(node) = visits / H over an origin's walk trace of H hops, the
origin's own visits zeroed, top-T by weight.  Counting is sort-based
run-length encoding (sort the trace row, find run starts, run length =
next start - start via a flipped cummin), so every intermediate is
[B, H] whatever the graph size.  Ties keep the JAX package's order: a
STABLE sort on -weight over runs that lie in ascending node order, so
equal weights list the lowest node id first.  Under identical traces the
top-T nodes and weights equal the JAX package's bit for bit, zero-weight
tail included.

The neighborhood cache (``.npz`` of ``weights``/``nodes``/``meta``/
``alpha``) is byte-compatible with the JAX package's: each package loads
what the other wrote.  ``refresh_neighborhoods`` re-sweeps only the
origins a graph augmentation can reach and saves the result under the
augmented graph's cache meta.  ``precompute_neighborhoods_multichip``
deals the sweep's blocks to the ranks of a ``torch.distributed`` world
and gives the same artifact.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.ops.walk_kernel import (
    random_walks,
    restart_walks,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    draw_uniforms,
    fused_walk_tables,
)
from gcn_song_embeddings_tpu_torch.utils.checkpoint import atomic_savez

# mixed into the refresh's generator seeds, so its walks draw apart from
# the sweep's (the JAX package folds the same constant into its key)
REFRESH_SALT = 0x5EF5E5


def visit_counts_topt(trace: torch.Tensor, nodeset: torch.Tensor, T: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-T visited nodes per trace row.

    trace [B, H] int32, nodeset [B] int32 walk origins.  Returns
    (weights [B, T] f32, nodes [B, T] int32): visit probabilities sorted
    descending, self excluded; rows with fewer than T distinct visits end
    in weight-0 entries whose node ids are duplicates (harmless in the
    weighted aggregate)."""
    B, H = trace.shape
    dev = trace.device
    s = torch.sort(trace, dim=1).values
    is_start = torch.ones((B, H), dtype=torch.bool, device=dev)
    is_start[:, 1:] = s[:, 1:] != s[:, :-1]
    idx = torch.arange(H, dtype=torch.int32, device=dev).expand(B, H)
    aux = torch.where(is_start, idx, torch.full_like(idx, H))
    next_start = torch.cummin(aux.flip(1), dim=1).values.flip(1)   # >= j
    next_after = torch.cat(
        [next_start[:, 1:],
         torch.full((B, 1), H, dtype=torch.int32, device=dev)], dim=1)
    counts = torch.where(is_start, next_after - idx, torch.zeros_like(idx))

    # times the f32 reciprocal of H: XLA compiles the JAX package's
    # division by the constant H so, and bit-identity follows it
    inv_h = 1.0 / torch.tensor(float(H), dtype=torch.float32, device=dev)
    weights = counts.to(torch.float32) * inv_h
    weights = torch.where(s == nodeset.to(s.dtype)[:, None],
                          torch.zeros_like(weights), weights)
    values = s
    if T > H:
        weights = torch.nn.functional.pad(weights, (0, T - H))
        values = torch.nn.functional.pad(values, (0, T - H))
    neg_w, order = torch.sort(-weights, dim=1, stable=True)
    nodes = torch.gather(values, 1, order[:, :T])
    return -neg_w[:, :T], nodes


def sample_neighborhood_topt_tables(tables, nodeset: torch.Tensor,
                                    n_hops: int, alpha: float, T: int,
                                    uniforms: torch.Tensor, n_chains: int = 1
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Restart walks from ``nodeset`` over prebuilt ``fused_walk_tables``
    (K1 on CUDA tensors) under ``uniforms`` [n_hops / n_chains,
    B * n_chains, 3], then their top-T visits -> (weights [B, T], nodes
    [B, T])."""
    trace = restart_walks(tables, nodeset, n_hops, alpha, uniforms, n_chains)
    return visit_counts_topt(trace, nodeset, T)


def effective_chains(n_hops: int, parallel_chains: int) -> int:
    """Largest divisor of `n_hops` that is <= `parallel_chains`."""
    w = max(1, min(parallel_chains, n_hops))
    while n_hops % w:
        w -= 1
    return w


def seeded_generator(entropy: list[int], device: torch.device
                     ) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``
    (through numpy's ``SeedSequence``, so nearby keys give unrelated
    streams)."""
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def block_generator(seed: int, start: int, device: torch.device
                    ) -> torch.Generator:
    """The generator of the sweep block that starts at origin `start`:
    seeded from (seed, start), so every block draws fresh uniforms and a
    rerun of the sweep repeats them."""
    return seeded_generator([seed, start], device)


def precompute_neighborhoods(graph: DeviceGraph, cfg: WalkConfig,
                             path: str | None, seed: int = 0,
                             verbose: bool = False
                             ) -> tuple[np.ndarray, np.ndarray]:
    """All-node top-``cfg.t_precompute`` PPR neighborhood sweep with a
    validated ``.npz`` cache.

    Origins are swept in blocks of ``cfg.batch_walkers``; each block draws
    its uniforms from ``block_generator(seed, block start)`` on the graph's
    device and walks with K1 (on CUDA) or its plain version (on the CPU).
    Returns numpy (weights [N, T] f32, nodes [N, T] int32)."""
    n_items = graph.n_items
    T = cfg.t_precompute
    cached = _load_cache(path, n_items, T, cfg, seed, graph.n_edges)
    if cached is not None:
        return cached

    dev = graph.device
    chains = effective_chains(cfg.n_hops, cfg.parallel_chains)
    tables = fused_walk_tables(graph)
    all_w = torch.zeros((n_items, T), dtype=torch.float32, device=dev)
    all_n = torch.zeros((n_items, T), dtype=torch.int32, device=dev)
    bs = cfg.batch_walkers
    for start in range(0, n_items, bs):
        stop = min(start + bs, n_items)
        nodeset = torch.arange(start, stop, dtype=torch.int32, device=dev)
        trace = random_walks(tables, nodeset, cfg.n_hops, cfg.alpha,
                             block_generator(seed, start, dev),
                             n_chains=chains)
        all_w[start:stop], all_n[start:stop] = visit_counts_topt(
            trace, nodeset, T)
        if verbose:
            print(f"neighborhoods: {stop}/{n_items} done")
    out_w, out_n = all_w.cpu().numpy(), all_n.cpu().numpy()
    _save_cache(path, out_w, out_n, cfg, seed, graph.n_edges)
    return out_w, out_n


def precompute_neighborhoods_multichip(graph: DeviceGraph, cfg: WalkConfig,
                                       path: str | None = None,
                                       seed: int = 0, group=None,
                                       verbose: bool = False
                                       ) -> tuple[np.ndarray, np.ndarray]:
    """Multi-device all-node PPR sweep: every rank of ``group`` (None:
    the world of ``torch.distributed``) holds the whole graph and runs
    K1 on its share of the sweep blocks, dealt round-robin.

    Block ``start`` draws from ``block_generator(seed, start, device)``
    as in ``precompute_neighborhoods``, so on one device type the
    artifact equals the single-process sweep's bit for bit and its cache
    meta holds for both.  The blocks' rows are summed over the ranks
    (every row comes from one rank, the others add exact zeros); every
    rank returns the numpy (weights, nodes) and rank 0 writes the cache.
    Outside a process group, or in a world of one, this is
    ``precompute_neighborhoods``."""
    import torch.distributed as dist

    from gcn_song_embeddings_tpu_torch.parallel import collectives as C

    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return precompute_neighborhoods(graph, cfg, path, seed=seed,
                                        verbose=verbose)
    n_items, T, dev = graph.n_items, cfg.t_precompute, graph.device
    cached = agreed_cache(path, n_items, T, cfg, seed, graph.n_edges, dev,
                          group)
    if cached is not None:
        return cached
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    chains = effective_chains(cfg.n_hops, cfg.parallel_chains)
    tables = fused_walk_tables(graph)
    all_w = torch.zeros((n_items, T), dtype=torch.float32, device=dev)
    all_n = torch.zeros((n_items, T), dtype=torch.int32, device=dev)
    bs = cfg.batch_walkers
    for block, start in enumerate(range(0, n_items, bs)):
        if block % world != rank:
            continue
        stop = min(start + bs, n_items)
        nodeset = torch.arange(start, stop, dtype=torch.int32, device=dev)
        trace = random_walks(tables, nodeset, cfg.n_hops, cfg.alpha,
                             block_generator(seed, start, dev),
                             n_chains=chains)
        all_w[start:stop], all_n[start:stop] = visit_counts_topt(
            trace, nodeset, T)
        if verbose:
            print(f"neighborhoods[rank {rank}/{world}]: block "
                  f"{start}-{stop} of {n_items} done")
    out_w = C.all_reduce(all_w, group).cpu().numpy()
    out_n = C.all_reduce(all_n, group).cpu().numpy()
    if rank == 0:
        _save_cache(path, out_w, out_n, cfg, seed, graph.n_edges)
    dist.barrier(group=group)
    return out_w, out_n


def agreed_cache(path, n_items, T, cfg, seed, n_edges, device, group=None):
    """``_load_cache`` on every rank, used only where it loads on every
    rank (a rank that would sweep alone would hang its peers)."""
    from gcn_song_embeddings_tpu_torch.parallel import collectives as C

    cached = _load_cache(path, n_items, T, cfg, seed, n_edges)
    return cached if C.all_true(cached is not None, device, group) else None


def _neighborhood_sweep_nodeset(tables, origins: torch.Tensor,
                                n_hops: int, alpha: float, T: int,
                                uniforms, batch: int, n_chains: int = 1,
                                progress=None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Walks + top-T over an explicit origin array (the refresh walks only
    the affected origins), in blocks of ``batch`` (the last one padded
    with its last origin): K1 on CUDA tensors, the plain walk on the CPU.

    ``tables`` are ``fused_walk_tables`` of the graph, ``origins`` [n]
    int.  ``uniforms`` is a ``torch.Generator`` (each block draws its
    [n_hops / n_chains, batch * n_chains, 3] uniforms from it in turn) or
    a callable ``(start, n_walkers)`` giving the block at offset
    ``start`` of ``origins`` its uniforms.  ``progress(stop)`` is called
    after each block.  Returns (weights [n, T] f32, nodes [n, T] int32)
    on the origins' device; under the same uniforms a block's rows equal
    the JAX package's ``_neighborhood_sweep_nodeset``'s bit for bit."""
    if isinstance(uniforms, torch.Generator):
        gen = uniforms

        def uniforms(start, n_walkers):
            return draw_uniforms(n_hops // n_chains, n_walkers, gen)
    n = origins.shape[0]
    dev = origins.device
    origins = origins.to(torch.int32)
    out_w = torch.empty((n, T), dtype=torch.float32, device=dev)
    out_n = torch.empty((n, T), dtype=torch.int32, device=dev)
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        block = origins[stop - 1].repeat(batch)
        block[:stop - start] = origins[start:stop]
        w, nodes = sample_neighborhood_topt_tables(
            tables, block, n_hops, alpha, T,
            uniforms(start, batch * n_chains), n_chains)
        out_w[start:stop] = w[:stop - start]
        out_n[start:stop] = nodes[:stop - start]
        if progress is not None:
            progress(stop)
    return out_w, out_n


def affected_origins(old_w: np.ndarray, old_n: np.ndarray,
                     added_pairs: np.ndarray, n_items: int) -> np.ndarray:
    """Origins whose cached top-T neighborhood can change when the item
    pairs in ``added_pairs`` gain edges: every endpoint, and every origin
    whose cached top-T holds an endpoint at a weight > 0 (visit mass
    outside the top-T is what the cache already drops).  Sorted int32."""
    touched = np.unique(np.asarray(added_pairs, np.int64)[:, :2].ravel())
    touched = touched[(touched >= 0) & (touched < n_items)]
    lut = np.zeros(n_items, dtype=bool)
    lut[touched] = True
    mask = lut[old_n] & (old_w > 0)
    aff = np.flatnonzero(mask.any(axis=1))
    return np.union1d(aff, touched).astype(np.int32)


def refresh_neighborhoods(graph: DeviceGraph, cfg: WalkConfig,
                          old_w: np.ndarray, old_n: np.ndarray,
                          added_pairs: np.ndarray, path: str | None = None,
                          seed: int = 0, verbose: bool = False,
                          uniforms=None) -> tuple[np.ndarray, np.ndarray]:
    """Re-sweep the cached top-T neighborhoods that a graph augmentation
    can change.

    ``graph`` is the augmented graph (the ``added_pairs``' edges are in
    it) and ``old_w``/``old_n`` the artifact swept before the
    augmentation.  Only ``affected_origins`` are walked again, in blocks
    of ``cfg.batch_walkers`` (the last one padded with its last id), with
    K1 on CUDA and the plain walk on the CPU; every other row is kept.
    ``uniforms(start, n_walkers)`` gives the block at offset ``start`` of
    the affected list its [n_hops / chains, n_walkers, 3] uniforms
    (default: a generator seeded from (seed, ``REFRESH_SALT``, start) on
    the graph's device).  The result is saved under the augmented
    graph's cache meta, so ``precompute_neighborhoods`` on that graph (in
    either package) serves it."""
    n_items = graph.n_items
    T = cfg.t_precompute
    if old_w.shape != (n_items, T) or old_n.shape != (n_items, T):
        raise ValueError(f"old artifact shape {old_w.shape} != "
                         f"({n_items}, {T})")
    aff = affected_origins(old_w, old_n, added_pairs, n_items)
    new_w = np.array(old_w, dtype=np.float32, copy=True)
    new_n = np.array(old_n, dtype=np.int32, copy=True)
    if verbose:
        print(f"refresh: {len(aff)}/{n_items} origins affected "
              f"({100 * len(aff) / max(n_items, 1):.1f}%)")
    if len(aff):
        dev = graph.device
        chains = effective_chains(cfg.n_hops, cfg.parallel_chains)
        if uniforms is None:
            def uniforms(start, n_walkers):
                return draw_uniforms(
                    cfg.n_hops // chains, n_walkers,
                    seeded_generator([seed, REFRESH_SALT, start], dev))

        def progress(stop):
            if verbose:
                print(f"refresh: {stop}/{len(aff)} re-swept")

        out_w, out_n = _neighborhood_sweep_nodeset(
            fused_walk_tables(graph), torch.as_tensor(aff, device=dev),
            cfg.n_hops, cfg.alpha, T, uniforms, cfg.batch_walkers, chains,
            progress)
        new_w[aff] = out_w.cpu().numpy()
        new_n[aff] = out_n.cpu().numpy()
    _save_cache(path, new_w, new_n, cfg, seed, graph.n_edges)
    return new_w, new_n


def _cache_meta(cfg: WalkConfig, seed: int, n_edges: int
                ) -> tuple[np.ndarray, np.float64]:
    # the seed is not part of the cache key (the artifact is a statistical
    # estimate whose distribution does not depend on it); hops, alpha, the
    # chain split and the swept graph's edge count are
    del seed
    chains = effective_chains(cfg.n_hops, cfg.parallel_chains)
    return (np.array([cfg.n_hops, chains, n_edges], dtype=np.int64),
            np.float64(cfg.alpha))


def _save_cache(path, all_w, all_n, cfg, seed, n_edges) -> None:
    """Write the artifact atomically (``atomic_savez``), so a resumed run
    never loads a truncated one.  The name gets ``.npz`` appended where it
    lacks it, as ``np.savez_compressed`` does."""
    if path is None:
        return
    if not path.endswith(".npz"):
        path += ".npz"
    meta, alpha = _cache_meta(cfg, seed, n_edges)
    atomic_savez(path, compressed=True, weights=all_w, nodes=all_n,
                 meta=meta, alpha=alpha)


def _load_cache(path, n_items, T, cfg, seed, n_edges):
    """Shape-, id-range- and walk-parameter-validated reload (None =
    recompute).  The ids index device tables in K2, so an id outside
    [0, n_items) is refused here rather than read out of bounds there."""
    if path is None or not os.path.isfile(path):
        return None
    with np.load(path) as z:
        weights, nodes = z["weights"], z["nodes"]
        meta = z["meta"] if "meta" in z.files else None
        alpha = float(z["alpha"]) if "alpha" in z.files else None
    if weights.shape != (n_items, T) or nodes.shape != (n_items, T):
        return None
    if nodes.size and (nodes.min() < 0 or nodes.max() >= n_items):
        return None
    want_meta, want_alpha = _cache_meta(cfg, seed, n_edges)
    if meta is None or alpha is None:
        return None
    if not (np.array_equal(meta, want_meta)
            and np.isclose(alpha, float(want_alpha))):
        return None
    return weights, nodes
