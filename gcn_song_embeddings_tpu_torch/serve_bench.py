"""Serving latency and throughput under load, through real HTTP clients.

The port's counterpart of ``scripts/serve_bench.py``, without JAX.  It
starts the port's HTTP server (``serve.serve``, the ``QueryBatcher``
dispatcher on) over a seeded catalog of ``--tracks`` x ``--dim`` normal
rows and measures:

* single-query latency: p50 / p99 / mean over ``--queries`` sequential
  ``GET /knn?index=...&k=10``;
* concurrent load: ``--clients`` threads x ``--queries`` queries -- the
  wall, the QPS and each request's p50 / p99 (the dispatcher coalesces
  them into batches);
* the batched endpoint: 10 requests of ``--batch`` rows, p50 and QPS;
* with ``--adds N``: N ``POST /add`` batches of 16 tracks, then query
  latency with the delta outstanding (embedding index only).

``--int8`` serves the int8 table; ``--hybrid`` serves the walk-head +
embedding-tail ranker over a synthetic bipartite graph (degree 8,
``tracks // 4`` playlists, ``tracks // 2`` co-listen pairs), with walks
of ``--hops`` hops split into ``--chains`` chains per batch (K1), or with
``--cached-head`` its head read from a sweep made first.  Every pow2
batch bucket is warmed before the clock starts, and every answer must
hold k neighbours and never the query::

    python -m gcn_song_embeddings_tpu_torch.serve_bench [--tracks 100000]
        [--int8] [--hybrid [--cached-head]] [--adds 8] [--device cpu]

Prints one JSON summary.  Runs on the GPU unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request
from typing import NamedTuple

import numpy as np

from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import _build_csr
from gcn_song_embeddings_tpu_torch.scale_demo import platform
from gcn_song_embeddings_tpu_torch.serve import (
    EmbeddingIndex,
    HybridIndex,
    serve,
)
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

K = 10          # neighbours a query asks for
ADD_ROWS = 16   # tracks a POST /add batch carries


class BenchRun(NamedTuple):
    """The printed summary, the catalog served, every single query's
    answer (query row -> (neighbour rows, scores), sequential and
    concurrent), the device bytes of the served index's tables and the
    walls of set-up."""
    summary: dict
    emb: np.ndarray
    answers: dict
    table_bytes: int
    setup: dict


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(int(p / 100 * len(xs)), len(xs) - 1)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tracks", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--hybrid", action="store_true",
                    help="serve the walk-head + embedding-tail hybrid over "
                         "a synthetic bipartite graph")
    ap.add_argument("--hops", type=int, default=1000)
    ap.add_argument("--chains", type=int, default=1,
                    help="hybrid: split the hop budget across lockstep "
                         "chains (latency knob)")
    ap.add_argument("--cached-head", action="store_true",
                    help="hybrid walk head from a precomputed artifact "
                         "(a sweep first; no walks per query)")
    ap.add_argument("--adds", type=int, default=0,
                    help="measure online adds: N POST /add batches of 16 "
                         "tracks, then query latency with the delta "
                         "outstanding (embedding index only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def synthetic_graph(tracks: int, rng: np.random.Generator, device
                    ) -> tuple[DeviceGraph, np.ndarray]:
    """A bipartite graph at catalog scale, drawn from ``rng`` (after the
    catalog's rows): each track in 8 uniform random playlists of
    ``tracks // 4``, built as CSR arrays (no JSON round trip), then
    ``tracks // 2`` random co-listen pairs.  Returns the graph on
    ``device`` and the pairs."""
    n_cols = max(tracks // 4, 1)
    deg = 8
    src = np.repeat(np.arange(tracks, dtype=np.int64), deg)
    dst = rng.integers(0, n_cols, size=src.size)
    i2c = _build_csr(src, dst, tracks)
    c2i = _build_csr(dst, src, n_cols)
    dg = DeviceGraph.from_arrays(i2c.indptr, i2c.indices, c2i.indptr,
                                 c2i.indices, device)
    pairs = rng.integers(0, tracks, size=(tracks // 2, 2)).astype(np.int64)
    return dg, pairs


def table_bytes(index: EmbeddingIndex) -> int:
    """Device bytes of the index's tables: the f32 rows or the int8 rows
    and scales, plus the hybrid's head artifact or walk tables."""
    tensors = ([index.q_values, index.q_scales] if index.quantized
               else [index.unit])
    if isinstance(index, HybridIndex):
        tensors += ([index.nbhd_w, index.nbhd_n] if index.tables is None
                    else list(index.tables))
    return int(sum(t.numel() * t.element_size() for t in tensors))


def check_answer(neighbors: list, row: int, k: int = K
                 ) -> tuple[list[int], list[float]]:
    """(neighbour rows, scores) of one query's answer; raises unless they
    are ``k`` distinct rows without the query's own."""
    ids = [n["index"] for n in neighbors]
    if len(ids) != k or len(set(ids)) != k or row in ids:
        raise RuntimeError(f"bad answer for row {row}: {ids}")
    return ids, [n["score"] for n in neighbors]


def build_index(args: argparse.Namespace, emb: np.ndarray, rng, dev,
                log=print) -> tuple[EmbeddingIndex, dict]:
    """The index the run serves, and the walls of building it."""
    setup = {}
    if not args.hybrid:
        return EmbeddingIndex(emb, quantized=args.int8, device=dev), setup
    t0 = time.perf_counter()
    dg, pairs = synthetic_graph(args.tracks, rng, dev)
    setup["graph_s"] = time.perf_counter() - t0
    if not args.cached_head:
        return HybridIndex(emb, dg, train_pairs=pairs, colisten_copies=1,
                           n_hops=args.hops, parallel_chains=args.chains,
                           quantized=args.int8, device=dev), setup
    # the walks amortized offline: sweep the artifact once, serve the
    # head from it (two gathers a query)
    from gcn_song_embeddings_tpu_torch.config import WalkConfig
    from gcn_song_embeddings_tpu_torch.data.device import (
        augment_with_colisten,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods,
    )

    aug = augment_with_colisten(dg, pairs, 1)
    t0 = time.perf_counter()
    nbhds = precompute_neighborhoods(aug, WalkConfig(batch_walkers=8192),
                                     None)
    setup["head_sweep_s"] = time.perf_counter() - t0
    log(f"offline head sweep: {setup['head_sweep_s']:.1f} s")
    return HybridIndex(emb, nbhds=nbhds, quantized=args.int8,
                       device=dev), setup


def run(args: argparse.Namespace, log=print) -> BenchRun:
    """Build the index, serve it on a free local port, warm it, then the
    sequential, concurrent, batched (and adds) measurements."""
    if args.adds and args.hybrid:
        raise SystemExit("--adds measures the embedding index (hybrid "
                         "indexes reject online adds)")
    dev = resolve_device(args.device)
    log("device:", platform(dev))
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(args.tracks, args.dim)).astype(np.float32)
    index, setup = build_index(args, emb, rng, dev, log)
    server = serve(index, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    answers: dict = {}

    def get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=600) as r:
            return json.loads(r.read())

    try:
        # warm every pow2 batch bucket this run will touch
        log("warming the batch buckets...")
        b = 1
        while b <= max(args.batch, args.clients):
            t0 = time.perf_counter()
            index.knn_rows(np.arange(b) % args.tracks, K)
            log(f"  bucket {b}: {time.perf_counter() - t0:.3f} s")
            b *= 2

        qrows = rng.integers(0, args.tracks,
                             size=args.queries * args.clients)

        # --- sequential single-query latency ----------------------------
        lat = []
        for q in qrows[: args.queries]:
            t0 = time.perf_counter()
            res = get(f"/knn?index={q}&k={K}")
            lat.append(time.perf_counter() - t0)
            answers[int(q)] = check_answer(res["neighbors"], int(q))
        seq = {"p50_ms": round(1e3 * pct(lat, 50), 2),
               "p99_ms": round(1e3 * pct(lat, 99), 2),
               "mean_ms": round(1e3 * sum(lat) / len(lat), 2)}
        log("sequential:", seq)

        # --- concurrent clients -----------------------------------------
        clat: list = []
        errors: list = []
        lock = threading.Lock()

        def client(ci):
            mine = qrows[ci * args.queries:(ci + 1) * args.queries]
            for q in mine:
                t0 = time.perf_counter()
                try:
                    answer = check_answer(get(f"/knn?index={q}&k={K}")
                                          ["neighbors"], int(q))
                except Exception as e:  # noqa: BLE001 -- raised below
                    with lock:
                        errors.append(e)
                    return
                with lock:
                    clat.append(time.perf_counter() - t0)
                    answers[int(q)] = answer

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cwall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"{len(errors)} concurrent clients failed: "
                               f"{errors[:2]}") from errors[0]
        conc = {"clients": args.clients,
                "total_queries": len(clat),
                "wall_s": round(cwall, 2),
                "qps": round(len(clat) / cwall, 1),
                "p50_ms": round(1e3 * pct(clat, 50), 2),
                "p99_ms": round(1e3 * pct(clat, 99), 2)}
        log("concurrent:", conc)

        # --- batched endpoint -------------------------------------------
        blat = []
        for _ in range(10):
            rows = rng.integers(0, args.tracks, size=args.batch)
            t0 = time.perf_counter()
            res = get("/knn?indices=" + ",".join(map(str, rows))
                      + f"&k={K}")
            blat.append(time.perf_counter() - t0)
            if len(res["neighbors"]) != args.batch:
                raise RuntimeError(f"{len(res['neighbors'])} answers to a "
                                   f"batch of {args.batch}")
            for row, nbrs in zip(rows, res["neighbors"]):
                check_answer(nbrs, int(row))
        bat = {"batch": args.batch,
               "p50_ms": round(1e3 * pct(blat, 50), 2),
               "qps": round(args.batch / pct(blat, 50), 1)}
        log("batched:", bat)

        # --- online adds (POST /add) ------------------------------------
        adds = None
        if args.adds:
            alat = []
            for i in range(args.adds):
                vecs = rng.normal(size=(ADD_ROWS, args.dim)).astype(
                    np.float32)
                body = json.dumps({"tracks": [
                    {"track": f"new_{i}_{j}", "embedding": v.tolist()}
                    for j, v in enumerate(vecs)]}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/add", data=body,
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as r:
                    res = json.loads(r.read())
                alat.append(time.perf_counter() - t0)
                if res["tracks"] != args.tracks + ADD_ROWS * (i + 1):
                    raise RuntimeError(f"/add: catalog of {res['tracks']}")
            # query latency with the delta outstanding, querying one of
            # the added rows
            new_row = index.row_of["new_0_0"]
            qlat = []
            for _ in range(args.queries):
                t0 = time.perf_counter()
                res = get(f"/knn?track=new_0_0&k={K}")
                qlat.append(time.perf_counter() - t0)
                check_answer(res["neighbors"], new_row)
            adds = {"batches": args.adds, "rows_per_batch": ADD_ROWS,
                    "add_p50_ms": round(1e3 * pct(alat, 50), 2),
                    "add_p99_ms": round(1e3 * pct(alat, 99), 2),
                    "query_with_delta_p50_ms": round(1e3 * pct(qlat, 50),
                                                     2)}
            log("adds:", adds)
        nbytes = table_bytes(index)
    finally:
        server.shutdown()
        server.server_close()

    summary = {
        "tracks": args.tracks, "dim": args.dim, "int8": args.int8,
        "hybrid": args.hybrid,
        **({"hops": args.hops, "chains": args.chains,
            "cached_head": args.cached_head} if args.hybrid else {}),
        "platform": platform(dev),
        "sequential": seq, "concurrent": conc, "batched": bat,
        **({"online_adds": adds} if adds else {})}
    return BenchRun(summary, emb, answers, nbytes, setup)


def main(argv=None) -> dict:
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    summary = run(parse_args(argv), log).summary
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
