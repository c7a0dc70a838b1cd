"""Large-batch train-step strategy A/B: frontier expansion vs full graph.

The port's counterpart of ``scripts/fullgraph_bench.py``, without JAX.
The frontier forward gathers 3B*(T+1)^l feature rows a step (K3 on the
GPU), the full-graph forward (``train.fullgraph_forward="on"``) convolves
the whole catalog, N*T rows a layer whatever B (K2), and indexes the
triple batch out of it; the math is the same.  ``train.fullgraph_forward
="auto"`` picks between them by ``models.pinsage.fullgraph_wins``, a rule
fitted to the JAX package's TPU timings.

For each batch size B, each strategy runs the trainer's chunk
(``train.trainer.train_chunk``) on the JAX script's data (numpy seed 0:
N random 512-d features, 100-wide random neighborhoods, 50,000
positives; T=3, two layers, hidden 512, out 128) and its difference
method gives the time a batch: (wall of a ``--chunk-large`` chunk - wall
of a ``--chunk-small`` chunk) / their difference, the median of 3, each
wall ending when the chunk's metrics reach the host.  One JSON object:
``B{B}_{off,on}_ms`` and ``_Medges_s`` (the script's edge count), the
1M-catalog embed by both ``embed_all`` strategies (``embed1m_{blocks,
fullgraph}_s``, warm, unless ``--skip-embed``), ``platform``, and
``auto_picks_winner``: for each B whether the rule picks the strategy
measured faster here::

    python -m gcn_song_embeddings_tpu_torch.fullgraph_bench \\
        [--tracks 20000] [--batches 128 1024 4096] [--chunk-small 20] \\
        [--chunk-large 100] [--skip-embed] [--device cpu]

Runs on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.models.pinsage import (
    embed_all,
    fullgraph_wins,
    init_pinsage,
)
from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
from gcn_song_embeddings_tpu_torch.scale_demo import platform
from gcn_song_embeddings_tpu_torch.train.trainer import (
    TrainTables,
    make_optimizer,
    train_chunk,
)
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

FEAT, HIDDEN, OUT, T, L = 512, 512, 128, 3, 2
EMBED_FEAT = 128


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tracks", type=int, default=20_000)
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[128, 1024, 4096])
    ap.add_argument("--chunk-small", type=int, default=20)
    ap.add_argument("--chunk-large", type=int, default=100)
    ap.add_argument("--embed-tracks", type=int, default=1_000_000)
    ap.add_argument("--skip-embed", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def edges_per_step(b: int, n_layers: int = L, t: int = T) -> int:
    """The script's edge count of a step (``scaling_bench``'s too): 3B
    rows, each level's rows times T, the next level (T + 1) times as
    many."""
    m, tot = 3 * b, 0
    for _ in range(n_layers):
        tot += m * t
        m *= (t + 1)
    return tot


def bench_data(rng: np.random.Generator, n: int, feature_dim: int = FEAT):
    """The script's training data (``scaling_bench``'s too), drawn in its
    order: features [n, feature_dim], neighborhood nodes [n, 100] and
    weights (descending), positives [50000, 2]."""
    features = rng.normal(size=(n, feature_dim)).astype(np.float32)
    nb_n = rng.integers(0, n, (n, 100)).astype(np.int32)
    nb_w = np.sort(rng.random((n, 100)).astype(np.float32),
                   axis=1)[:, ::-1].copy()
    positives = rng.integers(0, n, (50_000, 2)).astype(np.int32)
    return features, nb_n, nb_w, positives


def strategy_config(b: int, strategy: str) -> RunConfig:
    """The script's config of a batch size and strategy ("off" / "on")."""
    return config_with_overrides(RunConfig(run_name="fgbench"), {
        "model.in_dim": FEAT, "train.batch_size": b,
        "train.fullgraph_forward": strategy})


def seeded_params(dev, in_dim: int, n_layers: int = L,
                  hidden: int = HIDDEN, out: int = OUT):
    """The script's model (by default two layers, hidden 512, out 128)
    from seed 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return init_pinsage(gen, n_layers, in_dim, hidden, out)


# rounds of a difference measurement before a median that is not
# positive is refused (``positive_median``)
ATTEMPTS = 4


def positive_median(measure, what: str, attempts: int = ATTEMPTS) -> float:
    """The median of the differences that ``measure()`` returns, as
    (diffs, walls), measured again while that median is not positive, at
    most ``attempts`` rounds in all: a host stall inside one wall can turn
    a pair's difference negative, and no time is <= 0.  Raises, naming
    every round's walls, where each round's median is."""
    rounds = []
    for _ in range(attempts):
        diffs, walls = measure()
        median = float(np.median(diffs))
        if median > 0:
            return median
        rounds.append(walls)
    raise RuntimeError(f"{what}: the median difference stayed <= 0 in "
                       f"{attempts} rounds of walls {rounds}")


def chunk_difference(wall, small: int, large: int, reps: int = 3,
                     log=None) -> float:
    """Seconds a batch by the script's difference method: the median over
    ``reps`` of (``wall(large, 3 + 2i)`` - ``wall(small, 2 + 2i)``) /
    (large - small), ``wall(n_chunk, i)`` being the seconds of a chunk of
    ``n_chunk`` steps on the batches of generator i.  A median that is not
    positive is measured again (``positive_median``): the JAX script
    returns it as it is."""
    def measure():
        diffs, walls = [], []
        for i in range(reps):
            t_small = wall(small, 2 + 2 * i)
            t_large = wall(large, 3 + 2 * i)
            if log is not None:
                log(f"rep {i}: small({small})={t_small:.3f}s "
                    f"large({large})={t_large:.3f}s")
            diffs.append((t_large - t_small) / (large - small))
            walls.append((t_small, t_large))
        return diffs, walls
    return positive_median(measure, f"chunks of {small} and {large} steps")


def run(args: argparse.Namespace, log=print) -> dict:
    dev = resolve_device(args.device)
    log("device:", platform(dev))
    rng = np.random.default_rng(0)
    n = args.tracks
    features, nb_n, nb_w, positives = bench_data(rng, n)
    tables = TrainTables.build(features, nb_w, nb_n, T, dev)
    positives = torch.as_tensor(positives, device=dev)
    params = seeded_params(dev, FEAT)

    def timed(f) -> float:
        t0 = time.perf_counter()
        f()
        return time.perf_counter() - t0

    results = {"n_tracks": n, "platform": platform(dev)}
    winners = {}
    for b in args.batches:
        for strat in ("off", "on"):
            cfg = strategy_config(b, strat)
            p = copy.deepcopy(params)
            opt = make_optimizer(p, cfg.train)

            def chunk(n_chunk, i):
                metrics = train_chunk(
                    p, opt, tables, positives, block_generator(1, i, dev),
                    cfg.train, cfg.model, n, n_chunk, strat == "on")
                return float(metrics.sum())

            def wall(n_chunk, i):
                return timed(lambda: chunk(n_chunk, i))

            s, bg = args.chunk_small, args.chunk_large
            wall(s, 0)
            wall(bg, 1)
            ms = chunk_difference(wall, s, bg) * 1e3
            eps = edges_per_step(b) / (ms * 1e-3)
            log(f"B={b} fullgraph={strat}: {ms:.3f} ms/batch "
                f"({eps / 1e6:.1f}M edges/s)")
            results[f"B{b}_{strat}_ms"] = round(ms, 4)
            results[f"B{b}_{strat}_Medges_s"] = round(eps / 1e6, 1)
        on_wins = results[f"B{b}_on_ms"] < results[f"B{b}_off_ms"]
        winners[f"B{b}"] = fullgraph_wins(3 * b, n, L, T) == on_wins
    results["auto_picks_winner"] = winners
    log(f"auto picks the measured winner: {winners}")

    if not args.skip_embed:
        ne = args.embed_tracks
        feats_e = torch.as_tensor(
            rng.normal(size=(ne, EMBED_FEAT)).astype(np.float32), device=dev)
        nb_e = torch.as_tensor(rng.integers(0, ne, (ne, T)).astype(np.int32),
                               device=dev)
        nw_e = torch.as_tensor(rng.random((ne, T)).astype(np.float32),
                               device=dev)
        p_e = seeded_params(dev, EMBED_FEAT)
        for strat in ("blocks", "fullgraph"):
            def sweep(strat=strat):
                return embed_all(p_e, feats_e, nw_e, nb_e, ne, L, T,
                                 batch_size=4096, strategy=strat)[-1].cpu()
            t1 = timed(sweep)
            t2 = timed(sweep)
            log(f"embed {ne} tracks strategy={strat}: cold {t1:.2f}s "
                f"warm {t2:.2f}s ({ne / t2 / 1e3:.1f}k tracks/s)")
            results[f"embed1m_{strat}_s"] = round(t2, 2)
    return results


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    results = run(parse_args(argv), log)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
