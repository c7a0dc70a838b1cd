"""Merge of two ranked top-k lists (walk head + embedding tail).

Contract (the JAX package's ``merge_topk``):

  * output width k = max(head_k, tail_k);
  * each row starts with the head entries whose weight is > 0, in head
    order, their weights shifted above every tail weight (so re-sorting
    by weight keeps the merged order);
  * then the tail entries whose node is not already placed, in tail
    order, at their own weights;
  * slots past the placed entries repeat the last placed node at -inf.

Node ids must be distinct within each list; across lists the head wins.
"""

from __future__ import annotations

import torch


def merge_topk(head_w: torch.Tensor, head_n: torch.Tensor,
               tail_w: torch.Tensor, tail_n: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge [B, k1] head lists with [B, k2] tail lists ->
    (weights [B, max(k1, k2)] f32, nodes [B, max(k1, k2)] int32)."""
    B, k1 = head_n.shape
    k2 = tail_n.shape[1]
    k = max(k1, k2)
    dev = head_n.device
    dropped = k1 + k2                      # priority sentinel: sorts last

    pri_head = torch.where(head_w > 0,
                           torch.arange(k1, device=dev).expand(B, k1),
                           torch.full((B, k1), dropped, device=dev))
    pri_tail = (torch.arange(k2, device=dev) + k1).expand(B, k2)
    shift = (tail_w.abs().max() + 1.0) if tail_w.numel() else 1.0

    nodes = torch.cat([head_n, tail_n], dim=1).long()
    pris = torch.cat([pri_head, pri_tail], dim=1)
    weights = torch.cat([head_w + shift, tail_w], dim=1).to(torch.float32)

    # group duplicates with one stable sort on the combined (node,
    # priority) key: the first slot of each node run carries the winning
    # occurrence (head beats tail, valid beats dropped)
    _, order = torch.sort(nodes * (dropped + 1) + pris, dim=1, stable=True)
    n_s = torch.gather(nodes, 1, order)
    p_s = torch.gather(pris, 1, order)
    w_s = torch.gather(weights, 1, order)
    is_first = torch.ones_like(n_s, dtype=torch.bool)
    is_first[:, 1:] = n_s[:, 1:] != n_s[:, :-1]
    keep = is_first & (p_s < dropped)
    p2 = torch.where(keep, p_s, torch.full_like(p_s, dropped))
    w2 = torch.where(keep, w_s, torch.full_like(w_s, float("-inf")))

    # restore merge order: kept entries by priority, dropped ones last
    _, order = torch.sort(p2, dim=1, stable=True)
    n3 = torch.gather(n_s, 1, order)
    w3 = torch.gather(w2, 1, order)

    kept = keep.sum(dim=1)
    last = torch.gather(n3, 1, torch.clamp(kept - 1, min=0)[:, None])
    idx = torch.arange(n3.shape[1], device=dev).expand_as(n3)
    out_n = torch.where(idx < kept[:, None], n3, last)
    return w3[:, :k], out_n[:, :k].to(torch.int32)
