"""Multi-device scaling efficiency of sharded training (edges/s from one
device to N).

The port's counterpart of ``scripts/scaling_bench.py``, without JAX, on
``torch.distributed`` (one process a device).  The sharded train step
(``parallel.train_step.ShardedTrainer``) is timed on meshes over the
world's first 1, 2, 4, ... ranks (``make_mesh(ranks=...)``, the
counterpart of the JAX script's ``devices[:nd]``); ranks outside a size's
mesh idle while it runs.  The per-device batch stays constant (weak
scaling: ideal scaling is a flat step time), the graph axis is
``--graph-axis`` where the mesh allows it, and the data is the JAX
script's (numpy seed 0: random features, 100-wide neighborhoods, 50,000
positives).  Rank 0 prints one JSON object: per mesh size its ``mesh``,
``step_ms``, ``edges_per_s`` and ``scaling_efficiency`` against one
device, with ``platform`` and the collectives' ``backend``::

    torchrun --standalone --nproc-per-node N \\
        -m gcn_song_embeddings_tpu_torch.scaling_bench \\
        [--backend gloo] [--device cpu] [--steps 30]

Ranks run on their GPUs (NCCL) unless ``--device`` names another device.
Two ranks sharing one GPU need ``--backend gloo``: their collectives then
go through the host, so their efficiency measures gloo, not scaling.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch.distributed as dist

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.fullgraph_bench import (
    bench_data,
    edges_per_step,
)
from gcn_song_embeddings_tpu_torch.parallel import multihost
from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh
from gcn_song_embeddings_tpu_torch.parallel.train_step import ShardedTrainer
from gcn_song_embeddings_tpu_torch.scale_demo import platform


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tracks", type=int, default=20000)
    ap.add_argument("--feature-dim", type=int, default=256)
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--graph-axis", type=int, default=2,
                    help="graph-shard axis size when the mesh allows it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the rank's GPU)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on the "
                         "GPU, gloo on the CPU)")
    return ap.parse_args(argv)


def mesh_sizes(n_ranks: int) -> list[int]:
    """1, 2, 4, ... up to ``n_ranks``."""
    sizes, d = [], 1
    while d <= n_ranks:
        sizes.append(d)
        d *= 2
    return sizes


def run(args: argparse.Namespace, log=print) -> dict:
    """Time the sharded step on every mesh size, inside the world this
    process has joined; returns the results of the sizes this rank took
    part in (rank 0: every size), efficiencies included."""
    world, me = dist.get_world_size(), dist.get_rank()
    dev = multihost.rank_device()
    if me == 0:
        log(f"{world} ranks on {platform(dev)} ({dist.get_backend()})")
    n = args.tracks
    feat, nb_n, nb_w, pos = bench_data(np.random.default_rng(0), n,
                                       args.feature_dim)
    sizes = mesh_sizes(world)
    results = {}
    for nd in sizes:
        n_graph = args.graph_axis if nd % args.graph_axis == 0 and \
            nd >= args.graph_axis else 1
        mesh = make_mesh(n_dp=nd // n_graph, n_graph=n_graph,
                         ranks=list(range(nd)), device=dev)
        if mesh is not None:
            cfg = config_with_overrides(RunConfig(), {
                "model.in_dim": args.feature_dim,
                "train.batch_size": args.batch_per_device * nd,
            })
            tr = ShardedTrainer(mesh, cfg, n, feat, (nb_w, nb_n), pos)
            tr.train_chunk(args.steps)      # warm-up of the timed length
            t0 = time.perf_counter()
            tr.train_chunk(args.steps)      # returns host numpy: synced
            dt = (time.perf_counter() - t0) / args.steps
            edges = edges_per_step(cfg.train.batch_size, cfg.model.n_layers,
                                   cfg.model.T)
            results[nd] = {"mesh": dict(mesh.shape),
                           "step_ms": round(dt * 1e3, 2),
                           "edges_per_s": round(edges / dt, 0)}
            if me == 0:
                log(f"{nd} devices {dict(mesh.shape)}: {dt * 1e3:.2f} "
                    f"ms/step")
            del tr
        dist.barrier()
    if sizes[0] in results:
        base = results[sizes[0]]["edges_per_s"] / sizes[0]
        for nd in results:
            per_dev = results[nd]["edges_per_s"] / nd
            results[nd]["scaling_efficiency"] = round(per_dev / base, 3)
    return {**results, "platform": platform(dev),
            "backend": dist.get_backend()}


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    args = parse_args(argv)
    rank = multihost.initialize_multihost(device=args.device,
                                          backend=args.backend)
    try:
        out = run(args, log)
    finally:
        multihost.shutdown()
    if rank == 0:
        print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
