"""Restart random walks over extent-joined edge tables, in plain PyTorch.

For each origin, run ``n_hops`` two-step walks (item -> uniform random
collection -> uniform random item), record the reached item after every
hop, and restart to the origin with probability ``alpha`` AFTER each hop.

Randomness is an argument: the uniforms ``[hops, B, 3]`` f32 are drawn
by the caller (``draw_uniforms`` with a ``torch.Generator``, or handed
over from JAX in the tests), so under the same uniforms this walker
replays the JAX package's ``walks_from_fused_tables`` bit for bit.

``walks_from_fused_tables`` here is the plain version of kernel K1
(``ops.walk_kernel``, ``csrc/walk.cu``): one Python loop step per hop.
"""

from __future__ import annotations

import torch

from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph

Tables = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fused_walk_tables(graph: DeviceGraph) -> Tables:
    """Extent-joined edge tables: two dependent gathers per two-step hop.

      i2c_ext [nnz_i2c, 2] int32: for edge (item -> col), (c2i start, deg)
          of that col;
      c2i_ext [nnz_c2i, 3] int32: for edge (col -> item), (item id,
          i2c start, i2c deg);
      origin_ext [n_items, 2] int32: (i2c start, deg) of each item, for
          restarts.
    """
    i2c_ptr = graph.i2c_indptr.to(torch.int32)
    c2i_ptr = graph.c2i_indptr.to(torch.int32)
    i2c_deg = torch.diff(i2c_ptr)
    c2i_deg = torch.diff(c2i_ptr)
    cols = graph.i2c_indices.long()
    items = graph.c2i_indices.long()
    i2c_ext = torch.stack([c2i_ptr[cols], c2i_deg[cols]], dim=1)
    c2i_ext = torch.stack([items.to(torch.int32), i2c_ptr[items],
                           i2c_deg[items]], dim=1)
    origin_ext = torch.stack([i2c_ptr[:-1], i2c_deg], dim=1)
    return (origin_ext.contiguous(), i2c_ext.contiguous(),
            c2i_ext.contiguous())


def uniform_slot(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Uniform neighbor slot: min(trunc(u * f32(deg)), max(deg - 1, 0)).

    The single definition every walker shares: the f32 product truncated
    toward zero, byte for byte the JAX package's ``uniform_slot``."""
    return torch.minimum((u * deg.to(u.dtype)).to(torch.int32),
                         torch.clamp(deg - 1, min=0))


def chain_origins(nodeset: torch.Tensor, n_hops: int, n_chains: int
                  ) -> tuple[torch.Tensor, int]:
    """(walker origins, hops per walker) for ``n_chains`` lockstep chains
    per origin: each origin is repeated ``n_chains`` times and its hop
    budget split evenly (the JAX package's chain split)."""
    nodeset = nodeset.to(torch.int32)
    if n_chains > 1:
        if n_hops % n_chains:
            raise ValueError(f"n_chains={n_chains} must divide "
                             f"n_hops={n_hops}")
        return torch.repeat_interleave(nodeset, n_chains), n_hops // n_chains
    return nodeset, n_hops


def draw_uniforms(n_hops: int, n_walkers: int, generator: torch.Generator
                  ) -> torch.Tensor:
    """The walk's randomness: [n_hops, n_walkers, 3] f32 uniforms in
    [0, 1), drawn on the generator's device."""
    return torch.rand((n_hops, n_walkers, 3), generator=generator,
                      device=generator.device, dtype=torch.float32)


def walk_hops_plain(tables: Tables, origins: torch.Tensor,
                    uniforms: torch.Tensor, alpha: float) -> torch.Tensor:
    """Hop loop: trace [hops, B] int32 of the item reached at each hop."""
    origin_ext, i2c_ext, c2i_ext = tables
    alpha_f = torch.tensor(alpha, dtype=torch.float32,
                           device=uniforms.device)  # f32 compare, like JAX
    org_ext = origin_ext[origins.long()]
    cur = org_ext
    trace = []
    for u in uniforms:
        col = i2c_ext[(cur[:, 0] + uniform_slot(u[:, 0], cur[:, 1])).long()]
        row = c2i_ext[(col[:, 0] + uniform_slot(u[:, 1], col[:, 1])).long()]
        trace.append(row[:, 0])
        cur = torch.where((u[:, 2] < alpha_f)[:, None], org_ext, row[:, 1:3])
    if not trace:
        return torch.empty((0, origins.shape[0]), dtype=torch.int32,
                           device=origins.device)
    return torch.stack(trace)


def walks_from_fused_tables(tables: Tables, nodeset: torch.Tensor,
                            n_hops: int, alpha: float,
                            uniforms: torch.Tensor,
                            n_chains: int = 1) -> torch.Tensor:
    """Restart walks from ``nodeset`` -> trace [B, n_hops] int32.

    ``uniforms`` is [n_hops / n_chains, B * n_chains, 3] f32.  With
    ``n_chains > 1`` row b of the trace holds origin b's chains one after
    another (hop order is permuted; visit counting is order-blind)."""
    origins, hops = chain_origins(nodeset, n_hops, n_chains)
    _check_uniforms(uniforms, hops, origins.shape[0])
    trace = walk_hops_plain(tables, origins, uniforms, alpha)
    return trace.t().reshape(nodeset.shape[0], n_hops)


def _check_uniforms(uniforms: torch.Tensor, hops: int, n_walkers: int
                    ) -> None:
    if (uniforms.dtype != torch.float32
            or tuple(uniforms.shape) != (hops, n_walkers, 3)):
        raise ValueError(f"uniforms must be float32 [{hops}, {n_walkers}, 3]"
                         f", got {uniforms.dtype} {list(uniforms.shape)}")
