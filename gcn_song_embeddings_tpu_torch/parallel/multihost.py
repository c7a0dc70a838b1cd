"""Process-group setup: the ``torch.distributed`` form of
gcn_song_embeddings_tpu/parallel/multihost.py.

One process drives one device.  ``initialize_multihost`` joins this
process to the world: from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), from
explicit arguments, or, with neither, as a world of one (JAX's
single-process case).  A rank's device is ``cuda:{LOCAL_RANK %
device_count}`` unless the caller asks for the CPU; the backend is NCCL
on CUDA and gloo on the CPU, or what ``backend=`` names (gloo on CUDA
tensors is the two-rank world on one card).  Nothing drops to the CPU or
to one process by itself: a missing card, or a multi-process environment
that fails to join, raises.  Every process group gets a timeout, so a
rank that dies takes its peers down instead of hanging them.

The one wait that has no natural bound, a rank idling until rank 0 has
work for it (``serve --sharded`` between requests, ``all --mesh-graph``
while rank 0 prepares), goes through ``control_group``: a gloo group
over the world with ``IDLE_TIMEOUT`` (a year), made at init on every
rank.  Its messages are small CPU tensors; the work they announce runs
on the bounded groups.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from gcn_song_embeddings_tpu_torch.parallel.mesh import Mesh, make_mesh
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
IDLE_TIMEOUT = timedelta(days=365)
_state: dict = {"device": None, "timeout": timedelta(minutes=10),
                "control": None}


def _local_device(device, local_rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device: str | torch.device | None = None,
                         backend: str | None = None,
                         timeout_s: float = 600.0) -> int:
    """Join the world (idempotent); returns this process's rank.

    ``coordinator_address`` (``tcp://host:port``, ``file://path``, or
    ``host:port``) with ``num_processes`` and ``process_id`` sets the
    world up explicitly; else ``torchrun``'s environment does; else this
    process is a world of one."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    present = [v for v in _TORCHRUN if v in env]
    store, init = None, None
    if coordinator_address is not None or (num_processes or 1) > 1:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("an explicit multi-process world needs "
                             "coordinator_address, num_processes and "
                             "process_id")
        rank, world = process_id, num_processes
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        local = int(env.get("LOCAL_RANK", process_id))
    elif present and num_processes is None:
        if len(present) != len(_TORCHRUN):
            raise RuntimeError(
                f"torchrun environment incomplete: {present} set, "
                f"{[v for v in _TORCHRUN if v not in env]} missing; "
                f"refusing to continue as one process of a larger job")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init, local = "env://", int(env.get("LOCAL_RANK", 0))
    else:
        if int(env.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError(f"num_processes=1 inside a world of "
                               f"{env['WORLD_SIZE']} (torchrun)")
        rank, world, local = 0, 1, 0
        store = dist.HashStore()
    dev = _local_device(device, local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init, store=store,
                            rank=rank, world_size=world, timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
    _state.update(device=dev, timeout=timeout, control=control)
    return rank


def rank_device() -> torch.device:
    """This rank's device, as ``initialize_multihost`` chose it."""
    if _state["device"] is None:
        raise RuntimeError("call initialize_multihost first")
    return _state["device"]


def group_timeout() -> timedelta:
    return _state["timeout"]


def control_group():
    """The world's gloo group for waits on rank 0 (``IDLE_TIMEOUT``)."""
    if _state["control"] is None:
        raise RuntimeError("call initialize_multihost first")
    return _state["control"]


def wait_for_rank_0() -> None:
    """A barrier over the world that outwaits any bounded group: rank 0
    arrives when its work alone is done."""
    dist.barrier(group=control_group())


def make_global_mesh(n_graph: int = 1) -> Mesh:
    """(dp, graph) mesh over every process's rank: node tables shard over
    ``graph``, which should stay within a host so the table gathers ride
    its fast links."""
    return make_mesh(n_dp=dist.get_world_size() // n_graph, n_graph=n_graph)


def shutdown() -> None:
    """Leave the world (destroys every process group of this process)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(device=None, control=None)
