"""The collectives of the multi-device layer, over ``torch.distributed``.

Every function takes a process group (None: the world) and is entered by
every rank of that group in the same order, with tensors of the same
shape and dtype.  ``all_gather`` stacks the peers' tensors on a new
leading axis, ``reduce_scatter`` is JAX's ``psum_scatter`` (each peer
receives the sum of block ``rank`` of every peer's [g, ...] tensor),
``ring_pass`` is one ``ppermute`` hop (send to rank + 1, receive from
rank - 1).

Transport is chosen by backend, never by trying one and catching the
error: NCCL takes CUDA tensors as they are; gloo carries CPU tensors,
so a CUDA tensor on a gloo group is copied to the host, exchanged there
and copied back to its device.  That is the two-rank world on one card,
where NCCL refuses two ranks on the same GPU; the compute stays on the
card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the single-tensor forms; newer releases renamed them
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def _to_wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the group's backend carries it: contiguous, and on the
    host for a CUDA tensor on a gloo group."""
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[*s] on each peer -> [g, *s], peer i's tensor at index i."""
    g = dist.get_world_size(group)
    src = _to_wire(group, t)
    out = src.new_empty((g * src.numel(),))
    _ALL_GATHER(out, src.reshape(-1), group=group)
    return out.reshape((g,) + tuple(t.shape)).to(t.device)


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """[g, *s] on each peer -> [*s]: the sum over peers of their block
    ``rank``."""
    g = dist.get_world_size(group)
    if t.shape[0] != g:
        raise ValueError(f"reduce_scatter takes [{g}, ...], got "
                         f"{list(t.shape)}")
    src = _to_wire(group, t)
    out = src.new_empty((src.numel() // g,))
    _REDUCE_SCATTER(out, src.reshape(-1), group=group)
    return out.reshape(tuple(t.shape[1:])).to(t.device)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over peers, returned as a new tensor on ``t``'s device."""
    wire = _to_wire(group, t)
    if wire is t:
        wire = t.clone()
    dist.all_reduce(wire, group=group)
    return wire.to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every peer (returned; ``t`` of the
    receivers gives the shape and dtype)."""
    wire = _to_wire(group, t)
    if wire is t:
        wire = t.clone()
    root = dist.get_global_rank(group or dist.group.WORLD, src)
    dist.broadcast(wire, root, group=group)
    return wire.to(t.device)


def ring_pass(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to rank + 1 and return what rank - 1 sent (mod g)."""
    g = dist.get_world_size(group)
    if g == 1:
        return t
    pg = group or dist.group.WORLD
    me = dist.get_rank(group)
    wire = _to_wire(group, t)
    got = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, dist.get_global_rank(pg, (me + 1) % g),
                      group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(pg, (me - 1) % g),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got.to(t.device)


def all_true(flag: bool, device: torch.device, group=None) -> bool:
    """True where ``flag`` holds on every peer."""
    t = torch.tensor([0 if flag else 1], dtype=torch.int32, device=device)
    return int(all_reduce(t, group)[0]) == 0
