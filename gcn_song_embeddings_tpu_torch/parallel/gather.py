"""Distributed node-table gather: the boundary-exchange collective
(gcn_song_embeddings_tpu/parallel/gather.py on ``torch.distributed``).

Node-indexed tables (features [N, d], packed neighborhoods [N, 2T]) are
row-sharded over a ``graph`` process group: shard i holds global rows
[i*N/g, (i+1)*N/g).  A lookup of arbitrary global rows is the classic
sharded-embedding exchange:

    1. ``all_gather`` every peer's requested ids              [g, m]
    2. answer ALL requests from the local shard, zeros where a
       row lives elsewhere (masked gather)                    [g, m, d]
    3. ``reduce_scatter``: each peer receives the sum of every
       peer's answers to ITS requests                         [m, d]

Exactly one peer holds each row and ``x + 0`` is exact, so the result is
the row itself, bit for bit.  ``sharded_table_gather_ring`` sends the
(requests, partial answers) packet round the ring instead, one hop per
peer, with the same result.

JAX differentiates its collectives; ``torch.distributed`` does not, so
both forms go through ``TableGather``, whose backward is the gather's
transpose: ``all_gather`` the row gradients of every peer's requests and
``index_add_`` those of local rows into the local shard's gradient.  The
sharded full-graph train step needs it (it gathers layer activations
that depend on the parameters).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gcn_song_embeddings_tpu_torch.parallel import collectives as C


def _local(ids: torch.Tensor, my: int, rows: int):
    """Global row ids -> (local row ids, held here) for shard ``my``."""
    local = ids.long() - my * rows
    return local, (local >= 0) & (local < rows)


def _answer(table_local: torch.Tensor, req: torch.Tensor, my: int
            ) -> torch.Tensor:
    """Rows ``req`` (global ids, flat) from the local shard; zeros for
    rows other shards hold."""
    rows = table_local.shape[0]
    local, ok = _local(req, my, rows)
    got = table_local[local.clamp(0, rows - 1)]
    mask = ok.reshape((-1,) + (1,) * (got.dim() - 1))
    return torch.where(mask, got, torch.zeros((), dtype=got.dtype,
                                              device=got.device))


def _gather_scatter(table_local, flat, group):
    g, my = dist.get_world_size(group), dist.get_rank(group)
    all_ids = C.all_gather(flat, group)                       # [g, m]
    answers = _answer(table_local, all_ids.reshape(-1), my)
    out = C.reduce_scatter(
        answers.reshape((g, flat.shape[0]) + tuple(table_local.shape[1:])),
        group)
    return out, all_ids


def _gather_ring(table_local, flat, group):
    g, my = dist.get_world_size(group), dist.get_rank(group)
    req, acc = flat, _answer(table_local, flat, my)
    for _ in range(g - 1):
        req = C.ring_pass(req, group)
        acc = C.ring_pass(acc, group)
        acc = acc + _answer(table_local, req, my)
    if g > 1:
        # one final hop brings the fully answered packet home
        acc = C.ring_pass(acc, group)
    return acc, None


class TableGather(torch.autograd.Function):
    """Differentiable sharded gather (``ring`` picks the schedule)."""

    @staticmethod
    def forward(ctx, table_local, ids, group, ring):
        flat = ids.reshape(-1)
        row_shape = tuple(table_local.shape[1:])
        fn = _gather_ring if ring else _gather_scatter
        out, all_ids = fn(table_local, flat, group)
        ctx.group, ctx.flat, ctx.all_ids = group, flat, all_ids
        ctx.rows, ctx.row_shape = table_local.shape[0], row_shape
        return out.reshape(tuple(ids.shape) + row_shape)

    @staticmethod
    def backward(ctx, grad):
        group, rows, row_shape = ctx.group, ctx.rows, ctx.row_shape
        all_ids = ctx.all_ids
        if all_ids is None:                    # the ring form
            all_ids = C.all_gather(ctx.flat, group)
        m = ctx.flat.shape[0]
        grads = C.all_gather(grad.reshape((m,) + row_shape), group)
        local, ok = _local(all_ids.reshape(-1), dist.get_rank(group), rows)
        out = torch.zeros((rows,) + row_shape, dtype=grad.dtype,
                          device=grad.device)
        out.index_add_(0, local[ok], grads.reshape((-1,) + row_shape)[ok])
        return out, None, None, None


def sharded_table_gather(table_local: torch.Tensor, ids: torch.Tensor,
                         group=None) -> torch.Tensor:
    """Gather global rows ``ids`` (any shape, may differ per peer) from a
    row-sharded table -> [*ids.shape, *table_local.shape[1:]]."""
    return TableGather.apply(table_local, ids, group, False)


def sharded_table_gather_ring(table_local: torch.Tensor, ids: torch.Tensor,
                              group=None) -> torch.Tensor:
    """``sharded_table_gather`` on the ring schedule: every hop each peer
    answers the packet it just received and passes it on; after g hops it
    is home.  Same per-link volume as the reduce-scatter form, more
    steps; the result is identical."""
    return TableGather.apply(table_local, ids, group, True)


def gather_fn(gather_impl: str):
    """The gather named by ``gather_impl``: "psum_scatter" (the default
    schedule, named as in the JAX package) or "ring"."""
    if gather_impl not in ("psum_scatter", "ring"):
        raise ValueError(f"gather_impl must be 'psum_scatter' or 'ring', "
                         f"got {gather_impl!r}")
    return (sharded_table_gather_ring if gather_impl == "ring"
            else sharded_table_gather)
