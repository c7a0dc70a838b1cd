"""The (dp, graph) mesh of ranks, the ``torch.distributed`` form of
gcn_song_embeddings_tpu/parallel/mesh.py.

  * ``dp``    -- data parallelism over training triples,
  * ``graph`` -- graph parallelism: node-indexed tables (features,
                 neighborhoods) are row-sharded, so each rank holds N/g
                 rows.

One process drives one device.  The mesh's ranks (the world's, or some
of them: the counterpart of the JAX package's ``devices=``) are
laid out row-major as a [dp, graph] grid, as the JAX package reshapes its
devices: mesh rank ``d * g + i`` is graph shard ``i`` of dp row ``d``.
Each dp row gets one ``graph`` process group for the table gathers;
gradients are summed over the mesh's ``group`` (the world's, for a mesh
over every rank).  ``multihost.initialize_multihost`` must run first.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place (``rank``, its index in the mesh) in a [n_dp,
    n_graph] grid of ranks, its device, the ``graph`` process group of its
    dp row and the mesh's own ``group`` (None: the world)."""

    n_dp: int
    n_graph: int
    rank: int
    device: torch.device
    graph_group: object
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.n_dp, "graph": self.n_graph}

    @property
    def n_dev(self) -> int:
        return self.n_dp * self.n_graph

    @property
    def dp_index(self) -> int:
        return self.rank // self.n_graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.n_graph


def make_mesh(n_dp: int | None = None, n_graph: int | None = None,
              device: str | torch.device | None = None,
              timeout: timedelta | None = None,
              ranks: list[int] | None = None) -> Mesh | None:
    """A (dp, graph) mesh over ``ranks`` (default: every rank of the
    world), laid out in ascending rank order, or None on a rank outside
    them.

    With only one count given, the other is inferred from the number of
    ranks; with none, every rank is on the dp axis.  Every rank of the
    world calls it and creates every group, in the same order
    (``dist.new_group`` is collective), whether or not it is in the mesh:
    the dp rows' ``graph`` groups, and for a mesh over fewer ranks than
    the world its own ``group``.  ``device`` defaults to the rank's device
    from ``initialize_multihost``, ``timeout`` (of the new groups) to the
    world's."""
    from gcn_song_embeddings_tpu_torch.parallel import multihost

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.multihost.initialize_multihost first")
    world = dist.get_world_size()
    # ascending, as ``dist.new_group`` numbers a group's ranks
    ranks = list(range(world)) if ranks is None else sorted(ranks)
    if (len(set(ranks)) != len(ranks) or not ranks
            or min(ranks) < 0 or max(ranks) >= world):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a "
                         f"world of {world}")
    n = len(ranks)
    if n_dp is None and n_graph is None:
        n_dp, n_graph = n, 1
    elif n_dp is None:
        n_dp = n // n_graph
    elif n_graph is None:
        n_graph = n // n_dp
    if n_dp * n_graph != n:
        raise ValueError(f"mesh {n_dp}x{n_graph} != {n} ranks")
    timeout = timeout or multihost.group_timeout()
    me = dist.get_rank()
    rank = ranks.index(me) if me in ranks else None
    mine = None
    for d in range(n_dp):
        group = dist.new_group(ranks[d * n_graph:(d + 1) * n_graph],
                               timeout=timeout)
        if rank is not None and d == rank // n_graph:
            mine = group
    whole = None
    if n < world:
        whole = dist.new_group(ranks, timeout=timeout)
    if rank is None:
        return None
    dev = (torch.device(device) if device is not None
           else multihost.rank_device())
    return Mesh(n_dp, n_graph, rank, dev, mine, whole)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
