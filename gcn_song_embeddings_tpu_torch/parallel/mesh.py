"""The (dp, graph) mesh of ranks, the ``torch.distributed`` form of
gcn_song_embeddings_tpu/parallel/mesh.py.

  * ``dp``    -- data parallelism over training triples,
  * ``graph`` -- graph parallelism: node-indexed tables (features,
                 neighborhoods) are row-sharded, so each rank holds N/g
                 rows.

One process drives one device.  The world's ranks are laid out row-major
as a [dp, graph] grid, as the JAX package reshapes its devices: rank
``d * g + i`` is graph shard ``i`` of dp row ``d``.  Each dp row gets one
``graph`` process group for the table gathers; gradients are summed over
the world group.  ``multihost.initialize_multihost`` must run first.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a [n_dp, n_graph] grid of the world's ranks,
    its device, and the ``graph`` process group of its dp row."""

    n_dp: int
    n_graph: int
    rank: int
    device: torch.device
    graph_group: object

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
              timeout: timedelta | None = None) -> Mesh:
    """A (dp, graph) mesh over the world's ranks.

    With only one count given, the other is inferred from the world
    size; with none, every rank is on the dp axis.  Every rank creates
    every dp row's ``graph`` group, in the same order (``dist.new_group``
    is collective).  ``device`` defaults to the rank's device from
    ``initialize_multihost``, ``timeout`` (of the ``graph`` groups) to
    the world's."""
    from gcn_song_embeddings_tpu_torch.parallel import multihost

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.multihost.initialize_multihost first")
    n = dist.get_world_size()
    if n_dp is None and n_graph is None:
        n_dp, n_graph = n, 1
    elif n_dp is None:
        n_dp = n // n_graph
    elif n_graph is None:
        n_graph = n // n_dp
    if n_dp * n_graph != n:
        raise ValueError(f"mesh {n_dp}x{n_graph} != {n} ranks")
    rank = dist.get_rank()
    mine = None
    for d in range(n_dp):
        group = dist.new_group(list(range(d * n_graph, (d + 1) * n_graph)),
                               timeout=timeout or multihost.group_timeout())
        if d == rank // n_graph:
            mine = group
    dev = (torch.device(device) if device is not None
           else multihost.rank_device())
    return Mesh(n_dp, n_graph, rank, dev, mine)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
