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
what the other wrote.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.ops.walk_kernel import random_walks
from gcn_song_embeddings_tpu_torch.ops.walks import fused_walk_tables


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


def effective_chains(n_hops: int, parallel_chains: int) -> int:
    """Largest divisor of `n_hops` that is <= `parallel_chains`."""
    w = max(1, min(parallel_chains, n_hops))
    while n_hops % w:
        w -= 1
    return w


def block_generator(seed: int, start: int, device: torch.device
                    ) -> torch.Generator:
    """The generator of the sweep block that starts at origin `start`:
    seeded from (seed, start), so every block draws fresh uniforms and a
    rerun of the sweep repeats them."""
    state = np.random.SeedSequence([seed, start]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


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
    if path is None:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta, alpha = _cache_meta(cfg, seed, n_edges)
    np.savez_compressed(path, weights=all_w, nodes=all_n, meta=meta,
                        alpha=alpha)


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
