"""node2vec second-order biased random walks (own copy of
gcn_song_embeddings_tpu/ops/node2vec.py), in plain PyTorch on a device.

  * Weighted neighbors come from per-row alias tables (Walker's method),
    built on the host with the JAX package's stack algorithm, so the
    tables equal its own bit for bit.  Sampling is then two gathers and a
    compare.
  * The p/q bias is applied by rejection: propose from the alias table,
    accept with bias(candidate) / max_bias (1/p back to the previous node,
    1 for a neighbor of it, 1/q otherwise), ``rounds`` rounds, the last
    proposal kept if none was accepted.
  * Adjacency is a 32-step binary search over sorted CSR rows;
    ``build_alias_graph`` refuses rows that are not sorted.

The walk's randomness is an input (``WalkDraws``): the raw slot integers
in [0, 2^30), the alias and the accept uniforms.  Under the JAX package's
draws the walks equal its own exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

SLOT_RANGE = 1 << 30  # raw slot draws are integers in [0, SLOT_RANGE)


class AliasGraph(NamedTuple):
    """CSR + per-slot alias tables for O(1) weighted neighbor sampling."""

    indptr: torch.Tensor   # [n + 1] int64
    indices: torch.Tensor  # [nnz] int64
    prob: torch.Tensor     # [nnz] f32: alias acceptance probability
    alias: torch.Tensor    # [nnz] int64: in-row alias slot

    @property
    def n(self) -> int:
        return self.indptr.shape[0] - 1


class WalkDraws(NamedTuple):
    """The randomness of a batch of B walks of length L with R rejection
    rounds: the second node's slot [B] int and alias uniform [B] f32,
    then for every later step and round the slot, alias and accept draws
    [L - 2, R, B]."""

    slot0: torch.Tensor
    alias0: torch.Tensor
    slots: torch.Tensor
    alias_u: torch.Tensor
    accept_u: torch.Tensor


def alias_tables(indptr: np.ndarray, weights: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row alias tables (prob [nnz] f32, alias [nnz] int32) by the
    small/large stack algorithm, in float64 as the JAX package runs it."""
    nnz = weights.shape[0]
    prob = np.ones(nnz, dtype=np.float32)
    alias = np.zeros(nnz, dtype=np.int32)
    for v in range(indptr.shape[0] - 1):
        s, e = int(indptr[v]), int(indptr[v + 1])
        deg = e - s
        if deg == 0:
            continue
        w = weights[s:e].astype(np.float64)
        pr = (w / w.sum() * deg).tolist()
        small = [i for i in range(deg) if pr[i] < 1.0]
        large = [i for i in range(deg) if pr[i] >= 1.0]
        al = list(range(deg))
        while small and large:
            sm = small.pop()
            lg = large.pop()
            al[sm] = lg
            pr[lg] = pr[lg] - (1.0 - pr[sm])
            if pr[lg] < 1.0:
                small.append(lg)
            else:
                large.append(lg)
        prob[s:e] = np.minimum(pr, 1.0).astype(np.float32)
        alias[s:e] = al
    return prob, alias


def build_alias_graph(indptr: np.ndarray, indices: np.ndarray,
                      weights: np.ndarray | None = None,
                      device=None) -> AliasGraph:
    """Alias tables of every CSR row (host, O(E)), put on ``device``
    (default: the GPU).

    Rows must list their neighbors in increasing order (``_is_edge``
    binary-searches them)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if weights is None:
        weights = np.ones(indices.shape[0], dtype=np.float64)
    step = np.diff(indices)
    row_start = np.zeros(indices.shape[0], dtype=bool)
    row_start[indptr[:-1][indptr[:-1] < indices.shape[0]]] = True
    if not ((step > 0) | row_start[1:]).all():
        raise ValueError("CSR rows must hold strictly increasing neighbor "
                         "ids (the adjacency test binary-searches them)")
    prob, alias = alias_tables(indptr, weights)
    dev = resolve_device(device)
    return AliasGraph(*(torch.as_tensor(a, device=dev) for a in (
        indptr, indices, prob, alias.astype(np.int64))))


def _alias_sample(g: AliasGraph, nodes: torch.Tensor, slot_r: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """Weighted neighbor per node under raw slot draws ``slot_r`` and
    alias uniforms ``u`` (degree-0 nodes return themselves)."""
    start = g.indptr[nodes]
    deg = g.indptr[nodes + 1] - start
    slot = slot_r.long() % torch.clamp(deg, min=1)
    take_alias = u >= g.prob[start + slot]
    final_slot = torch.where(take_alias, g.alias[start + slot], slot)
    last = g.indices.shape[0] - 1
    nb = g.indices[torch.clamp(start + final_slot, max=last)]
    return torch.where(deg > 0, nb, nodes)


def _is_edge(g: AliasGraph, u: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
    """v in neighbors(u), by binary search over the sorted row."""
    lo = g.indptr[u]
    row_end = g.indptr[u + 1]
    hi = row_end
    last = g.indices.shape[0] - 1
    for _ in range(32):
        mid = (lo + hi) // 2
        val = g.indices[torch.clamp(mid, 0, last)]
        go_right = (val < v) & (lo < hi)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right, hi, mid))
    return (lo < row_end) & (g.indices[torch.clamp(lo, 0, last)] == v)


def draw_walks(n_walks: int, walk_length: int, rounds: int,
               generator: torch.Generator) -> WalkDraws:
    """``WalkDraws`` for ``n_walks`` walks from ``generator`` (on its
    device)."""
    dev = generator.device
    shape = (max(walk_length - 2, 0), rounds, n_walks)

    def ints(size):
        return torch.randint(0, SLOT_RANGE, size, generator=generator,
                             device=dev, dtype=torch.int32)

    def unif(size):
        return torch.rand(size, generator=generator, device=dev)

    return WalkDraws(ints((n_walks,)), unif((n_walks,)), ints(shape),
                     unif(shape), unif(shape))


def node2vec_walks(g: AliasGraph, starts: torch.Tensor, walk_length: int,
                   p: float, q: float, draws: WalkDraws) -> torch.Tensor:
    """[B] starts -> [B, walk_length] node sequences (column 0 = starts),
    p/q-biased, under ``draws`` (``rounds`` = its second axis)."""
    starts = starts.long()
    inv_p, inv_q = 1.0 / p, 1.0 / q
    max_bias = max(inv_p, 1.0, inv_q)
    # the JAX package compares in f32: bias / max_bias is an f32 quotient
    accept_at = {name: torch.tensor(b, dtype=torch.float32) / max_bias
                 for name, b in (("p", inv_p), ("edge", 1.0), ("q", inv_q))}
    accept_at = {k: v.to(starts.device) for k, v in accept_at.items()}
    prev, cur = starts, _alias_sample(g, starts, draws.slot0, draws.alias0)
    out = [prev, cur]
    for t in range(walk_length - 2):
        nxt = done = None
        for r in range(draws.slots.shape[1]):
            cand = _alias_sample(g, cur, draws.slots[t, r],
                                 draws.alias_u[t, r])
            bias = torch.where(
                cand == prev, accept_at["p"],
                torch.where(_is_edge(g, prev, cand), accept_at["edge"],
                            accept_at["q"]))
            accept = draws.accept_u[t, r] < bias
            if nxt is None:
                nxt, done = cand, accept
            else:
                nxt = torch.where(done, nxt, cand)
                done = done | accept
        prev, cur = cur, nxt
        out.append(cur)
    return torch.stack(out[:walk_length], dim=1)
