"""Triple batch sampling on the device (the JAX package's
``train/sampler.py``).

A batch is B positive pairs (query, positive) plus one negative each:
"easy" (a uniform item, redrawn twice where it hits a batch node) or
"hard" (the query's PPR neighbor at a uniform rank in [hn_min, hn_max)).
Every draw comes from an explicit ``torch.Generator`` on the device the
tensors live on.  It cannot give JAX's threefry numbers, so the batches
are held to the JAX suite's properties, not to its values.
"""

from __future__ import annotations

import torch


def sample_positive_rows(gen: torch.Generator, positives: torch.Tensor,
                         batch_size: int, exact: bool = False
                         ) -> torch.Tensor:
    """B positive pairs [B, 2]: rows drawn i.i.d., or with ``exact=True``
    the first B of a permutation (distinct rows within the batch)."""
    n_pos = positives.shape[0]
    dev = positives.device
    if exact:
        rows = torch.randperm(n_pos, generator=gen, device=dev)[:batch_size]
    else:
        rows = torch.randint(0, n_pos, (batch_size,), generator=gen,
                             device=dev)
    return positives[rows].to(torch.int32)


def sample_easy_negatives(gen: torch.Generator, pos_batch: torch.Tensor,
                          n_items: int) -> torch.Tensor:
    """One uniform negative per pair; two rejection rounds redraw the ones
    that hit a node of the batch."""
    b = pos_batch.shape[0]
    dev = pos_batch.device
    batch_nodes = pos_batch.reshape(-1)
    neg = torch.randint(0, n_items, (b,), generator=gen, device=dev)
    for _ in range(2):
        redraw = torch.randint(0, n_items, (b,), generator=gen, device=dev)
        in_batch = (neg[:, None] == batch_nodes[None, :]).any(dim=1)
        neg = torch.where(in_batch, redraw, neg)
    return neg.to(torch.int32)


def sample_hard_negatives(gen: torch.Generator, pos_batch: torch.Tensor,
                          nbhd_nodes: torch.Tensor, hn_min: int,
                          hn_max: int) -> torch.Tensor:
    """One negative per pair: the query's neighbor at a uniform rank in
    [hn_min, hn_max) (needs t_precompute >= hn_max)."""
    queries = pos_batch[:, 0].long()
    ranks = torch.randint(hn_min, hn_max, (pos_batch.shape[0],),
                          generator=gen, device=pos_batch.device)
    return nbhd_nodes[queries, ranks].to(torch.int32)


def sample_batch(gen: torch.Generator, positives: torch.Tensor,
                 nbhd_nodes: torch.Tensor, batch_size: int, n_items: int,
                 hard_negatives: bool = False, hn_min: int = 10,
                 hn_max: int = 100, exact: bool = False,
                 hn_gate: bool | None = None) -> torch.Tensor:
    """A [B, 3] int32 (query, positive, negative) batch.

    ``hn_gate`` (with ``hard_negatives``) picks hard (True) or easy
    (False) negatives for this batch: the curriculum of
    ``train.hn_start_epoch``.  The gate is known on the host, so only the
    chosen sampler draws."""
    pos_batch = sample_positive_rows(gen, positives, batch_size, exact)
    if hard_negatives and hn_gate is not False:
        neg = sample_hard_negatives(gen, pos_batch, nbhd_nodes, hn_min,
                                    hn_max)
    else:
        neg = sample_easy_negatives(gen, pos_batch, n_items)
    return torch.cat([pos_batch, neg[:, None]], dim=1)
