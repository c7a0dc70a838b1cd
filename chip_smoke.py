#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), turns TF32 off.
2. Builds every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints ``ptxas -v``'s register and
   shared-memory lines.
3. Drives the port's main path at the README's 100k scale with its
   launch counters set to 0: a 100k-track synthetic dataset (512-d
   features), ``SongGraph`` -> co-listen augmentation -> all-node PPR
   sweep (kernel K1) -> full-catalog ``embed_all`` of the full-width
   ``RunConfig.recommended()`` model from a seeded init (kernel K2) ->
   ``emb.npy`` -> HTTP serving of the hybrid ranker, live-walk (K1 per
   batch) and cached-head, answering single and batched queries.  Fails
   unless every kernel was launched.
4. Drives the training path with the counters set to 0 again: ``cli
   train`` of the same full-width model on the same dataset and cached
   sweep, 2 epochs x 25 batches of 128 triples in chunks of 20 (so a
   chunk crosses the epoch boundary), frontier forward (kernel K3, with
   the aggregation's backward), then ``emb.npy`` (K2) served through the
   cached-head hybrid.  Fails unless K2, K3 and the backward ran, the 50
   metric rows are finite, the loss fell, the rate stepped x0.95 at batch
   25 and a second trainer resumes at epoch 2 with the same embeddings.
5. Three-step checks from the seeded init on the same batches:
   ``fullgraph_forward`` on (K2 forward + backward at N=100k) against off
   (K3), every parameter at rtol 1e-4 / atol 1e-5; the card against the
   CPU (the plain versions), losses, G1_w and embeddings as
   tests/test_trainer.py holds them.  Then the train step's wall at B=128
   and a ``torch.profiler`` pass over it (device busy share, launches).
6. Drives the eval path with the counters set to 0 again: ``SongGraph``
   through the native ``graph.json`` reader (its ``load_graph_s`` beside
   the ``json`` module's time for the same file), then ``cli eval`` of
   the Random, Features, PageRank, PageRankCo (query-time walks, kernel
   K1) and trained PinSage rows at K=100 over the 100k catalog.  Fails
   unless K1 ran, both CSVs hold finite rows and every kNN cache is
   [100000, 100]; then ``rank_eval`` on the card over all test pairs must
   give the PinSage row's hit@10 and hit@100 within 1e-3 of the CSV's,
   the kNN ids of 256 PinSage queries on the card must equal a CPU f32
   recompute up to ties within 1e-6, and ``embed_all`` at N=100k must
   project once per layer (K2), at its default block and at
   ``block_rows=32_768`` alike (same embeddings within 1e-5).  Prints an
   ``eval_walls`` line.
7. Drives the int8 serving path on the trained ``emb.npy`` with the
   counters set to 0 again: the int8 ``EmbeddingIndex`` and the int8
   cached-head and live-walk (K1) ``HybridIndex`` answer single and batched
   HTTP requests; 16 tracks are added and 4 removed through ``POST /add``
   and ``/remove`` (the added ones found through their own embeddings,
   the removed ones gone, ``compact()`` leaving the answers unchanged);
   the served table is quantized with stochastic rounding (kernel K4).
   Then int8 scores on the card are held bit-equal to the CPU's, the
   int8-vs-f32 top-10 overlap and the device bytes of both tables are
   printed, and K4 is held to its plain version (``torch.equal``) and to
   the stochastic quantizer's contract (tests/test_quantize.py:40-48).
8. Holds each kernel against its plain PyTorch version on the card at the
   paths' shapes (K1 at the sweep's, alpha 0.85 and 0, at the live-walk
   requests' B=1 and B=4 and at eval's PageRank block of 1000, each
   timed with its own bound;
   K1 and K4 bit-identical, K2 and K3 within 1e-4
   absolute, K2's Wq split, projection and gather-mean each against its
   own plain version; the aggregation's backward within GRAD_RTOL of
   float64 autograd, beside the f32 plain version's own error), logs
   K2's and K3's max error against float64 beside the plain version's,
   and times kernel, plain version and a library yardstick with CUDA
   events, back to back on the device (K2 also against a project-once
   library composition); each kernel's ``host_ms`` is its time per call
   as the host issues them, its wrapper included.  K2's
   and K3's bounds count their products on the TF32 tensor cores in
   three passes (3xTF32); ``bound_f32_simt_ms`` keeps the f32 one.
9. Checks the outputs: finite embeddings of the expected shape that match
   the port's CPU path on a small node set, well-formed responses, and
   the ``embed`` CLI reproducing the same embeddings.

Ends with the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero (and prints no result)
when no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12   # f32 outside the tensor cores (data sheet, SXM)
H100_TF32_FLOPS = 495e12  # TF32 tensor cores, dense (data sheet, SXM)
H100_HBM_BYTES = 3.35e12  # HBM3 bytes/s (data sheet, SXM)
K2_ATOL = 1e-4  # f32 sums of Din products in another order: ~1e-6 expected
# the aggregation's backward: the relative Frobenius error of each
# gradient against autograd through the plain version in float64.  One
# entry of pre within f32 rounding of 0 takes the other leaky_relu slope
# than in float64 and moves dWq by ~2e-4 of its norm at the train step's
# shapes; the backward and the plain version reach pre through products
# of other row counts (cuBLAS picks its kernel by shape), so either may
# carry such an entry (measured on the card: 1e-7 to 2.6e-4 for both)
GRAD_RTOL = 1e-3
TRAJ = {"rtol": 1e-4, "atol": 1e-5}  # tests/test_trainer.py's 3-step bar
TRAIN_EPOCHS, TRAIN_BATCHES, TRAIN_CHUNK = 2, 25, 20

# the README's 100k scale: ~1M directed playlist edges
N_TRACKS, N_COLLECTIONS, TRACKS_PER_COLLECTION = 100_000, 25_000, 20
N_POSITIVES, FEATURE_DIM = 200_000, 512
SERVE_HOPS, QUERY_K = 1000, 10
N_ADDED, N_REMOVED, QUANT_SEED = 16, 4, 3


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2,
            queued: bool = True) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events.  ``queued``: a sleep kernel (~30 ms) holds the stream while
    the calls are queued, so the events time them back to back on the
    device and not the host's rate of issuing them.  Without it the time
    is per call as the host issues them, the wrapper's host work
    included: the ``host_ms`` of a kernel row, where a wrapper that
    outlasts its kernel shows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def post_json(url: str, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def check_neighbors(nbrs, query_row: int, k: int) -> None:
    ids = [n["index"] for n in nbrs]
    if len(ids) != k or len(set(ids)) != k or query_row in ids:
        raise AssertionError(f"bad neighbor list for row {query_row}: {ids}")
    if not all(isinstance(n["score"], float) for n in nbrs):
        raise AssertionError("non-float scores")


def serve_queries(serve, index, graph, rows, updates=None) -> dict:
    """Serve ``index`` on 127.0.0.1 in a thread, answer single and batched
    requests, check each response's shape, then run ``updates(base_url,
    walls)`` against the same server if given; returns request walls
    (ms)."""
    server = serve(index, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    walls = {}
    try:
        code, res = get_json(f"{base}/healthz")
        if code != 200 or res["tracks"] != graph.n_items:
            raise AssertionError(f"healthz: {code} {res}")
        for i, row in enumerate(rows[:3]):
            tid = graph.track_ids[row]
            t = time.perf_counter()
            code, res = get_json(f"{base}/knn?track={tid}&k={QUERY_K}")
            walls[f"single_{i}_ms"] = (time.perf_counter() - t) * 1e3
            if code != 200 or res["query"] != tid:
                raise AssertionError(f"knn track={tid}: {code}")
            check_neighbors(res["neighbors"], row, QUERY_K)
        tids = ",".join(graph.track_ids[r] for r in rows)
        t = time.perf_counter()
        code, res = get_json(f"{base}/knn?tracks={tids}&k={QUERY_K}")
        walls[f"batch{len(rows)}_ms"] = (time.perf_counter() - t) * 1e3
        if code != 200 or len(res["neighbors"]) != len(rows):
            raise AssertionError(f"knn tracks=: {code}")
        for row, nbrs in zip(rows, res["neighbors"]):
            check_neighbors(nbrs, row, QUERY_K)
        if updates is not None:
            updates(base, walls)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    return walls


def online_updates(index, graph, rows, twins):
    """``POST /add`` of the ``twins`` embeddings (pairs of near-equal
    random vectors, 16 new tracks) and ``POST /remove`` of the 4 queries'
    current top neighbors, on a served int8 ``EmbeddingIndex``; then
    ``compact()``.  Checks that each added track is found through its own
    embedding (``/embed`` returns it, its twin is its top neighbor at
    cosine ~1), that the removed tracks are gone, and that ``compact()``
    leaves the catalog queries' answers unchanged (ids and scores) and
    each added track's twin first.  Returns the function the server
    runs."""
    import numpy as np

    new_ids = [f"added_{i}" for i in range(len(twins))]
    pair = [i ^ 1 for i in range(len(twins))]

    def timed(walls, name, fn):
        t = time.perf_counter()
        out = fn()
        walls[name] = (time.perf_counter() - t) * 1e3
        return out

    def answers(base, tids):
        out = {}
        for tid in tids:
            code, res = get_json(f"{base}/knn?track={tid}&k={QUERY_K}")
            if code != 200:
                raise AssertionError(f"knn track={tid}: {code}")
            out[tid] = res["neighbors"]
        return out

    def run(base, walls):
        code, res = timed(walls, "add_ms", lambda: post_json(
            f"{base}/add", {"tracks": [
                {"track": tid, "embedding": v.tolist(), "name": tid}
                for tid, v in zip(new_ids, twins)]}))
        if code != 200 or res["rows"] != list(range(graph.n_items,
                                                    graph.n_items
                                                    + len(twins))):
            raise AssertionError(f"add: {code} {res}")
        for i, tid in enumerate(new_ids):
            _, emb = get_json(f"{base}/embed?track={tid}")
            unit = twins[i] / np.linalg.norm(twins[i])
            if not np.allclose(emb["embedding"], unit, atol=1e-6):
                raise AssertionError(f"/embed of {tid} is not its own")
        before = timed(walls, "added_knn_ms", lambda: answers(base,
                                                              new_ids))
        for i, tid in enumerate(new_ids):
            top = before[tid][0]
            if top["track"] != new_ids[pair[i]] or top["score"] < 0.999:
                raise AssertionError(f"{tid}: top neighbor {top}, not its "
                                     f"twin {new_ids[pair[i]]}")
        query_tids = [graph.track_ids[r] for r in rows]
        gone = [next(o["track"] for o in nbrs if o["track"] not in query_tids)
                for nbrs in answers(base, query_tids).values()]
        code, res = timed(walls, "remove_ms", lambda: post_json(
            f"{base}/remove", {"tracks": gone}))
        _, health = get_json(f"{base}/healthz")
        if code != 200 or health["removed"] != len(set(gone)):
            raise AssertionError(f"remove: {code} {res} {health}")
        for tid in gone:
            try:
                get_json(f"{base}/knn?track={tid}&k={QUERY_K}")
            except urllib.error.HTTPError as e:
                if e.code != 400:
                    raise
            else:
                raise AssertionError(f"removed {tid} still resolves")
        after_remove = answers(base, query_tids + new_ids)
        for tid, nbrs in after_remove.items():
            if len(nbrs) != QUERY_K or set(gone) & {n["track"]
                                                    for n in nbrs}:
                raise AssertionError(f"{tid}: a removed track is served")
        t = time.perf_counter()
        index.compact()
        walls["compact_s"] = time.perf_counter() - t
        after_compact = answers(base, query_tids + new_ids)
        for tid in query_tids:
            if after_compact[tid] != after_remove[tid]:
                raise AssertionError(f"{tid}: compact() changed the answer")
        # an added track's own list holds other added tracks, scored in
        # exact f32 before compact() and in int8 after it, so entries with
        # near-equal scores may change places; its twin stays first
        moved = 0
        for i, tid in enumerate(new_ids):
            ids = [n["track"] for n in after_remove[tid]]
            now = [n["track"] for n in after_compact[tid]]
            if now[0] != new_ids[pair[i]]:
                raise AssertionError(f"{tid}: after compact() its top "
                                     f"neighbor is {now[0]}")
            moved += ids != now
        walls["added_lists_reordered_by_compact"] = moved
        log(f"int8 online updates: {len(new_ids)} added (each twin's top "
            f"neighbor, cosine >= 0.999), {len(gone)} removed; compact() "
            f"in {walls['compact_s']:.3f} s left the {len(query_tids)} "
            f"catalog queries' answers unchanged and every twin first "
            f"({moved} of the added tracks' lists reordered)")

    return run


def run_int8_path(dev, st, tr_st) -> dict:
    """The int8 serving path, as a user runs it, on the trained
    ``emb.npy``: the int8 ``EmbeddingIndex`` (with adds, removals and
    compact through HTTP), the int8 cached-head and live-walk (K1)
    ``HybridIndex`` answering HTTP requests, and the served table
    quantized with stochastic rounding (K4).  Returns its walls and what
    the checks after it need."""
    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.ops.quant_kernel import (
        quantize_rows_stochastic,
    )

    graph, emb, rows = st.graph, tr_st.emb, st.rows
    meta = dict(track_ids=graph.track_ids, tracks_meta=graph.tracks)
    walls = {}
    sync(torch, dev)
    t = time.perf_counter()
    index = serve_mod.EmbeddingIndex(emb, quantized=True, device=dev,
                                     **meta)
    sync(torch, dev)
    walls["index_build_s"] = time.perf_counter() - t
    rng = np.random.default_rng(5)
    twins = np.repeat(rng.normal(size=(N_ADDED // 2, emb.shape[1])), 2,
                      axis=0).astype(np.float32)
    twins += 1e-3 * rng.normal(size=twins.shape).astype(np.float32)
    walls["embedding"] = serve_queries(
        serve_mod.serve, index, graph, rows,
        updates=online_updates(index, graph, rows, twins))
    cached = serve_mod.HybridIndex(emb, nbhds=(st.nb_w, st.nb_n),
                                   quantized=True, device=dev, **meta)
    walls["cached"] = serve_queries(serve_mod.serve, cached, graph, rows)
    t = time.perf_counter()
    live = serve_mod.HybridIndex(
        emb, DeviceGraph.from_graph(graph, dev), train_pairs=st.train_pos,
        colisten_copies=st.cfg.walk.colisten_copies, n_hops=SERVE_HOPS,
        quantized=True, device=dev, **meta)
    walls["live_index_build_s"] = time.perf_counter() - t
    walls["live"] = serve_queries(serve_mod.serve, live, graph, rows)
    # the served table, quantized with stochastic rounding (K4)
    table = torch.as_tensor(cached.unit_host, device=dev)
    sync(torch, dev)
    t = time.perf_counter()
    stochastic = quantize_rows_stochastic(table, seed=QUANT_SEED)
    sync(torch, dev)
    walls["stochastic_quantize_ms"] = (time.perf_counter() - t) * 1e3
    return {"walls": walls, "cached": cached, "table": table,
            "stochastic": stochastic}


def check_int8(torch, st, tr_st, it) -> dict:
    """The int8 path's outputs on the card: scores of 64 query rows
    bit-equal to the CPU's on the same table (ids equal up to ties), the
    device bytes of the int8 and f32 tables, and the int8-vs-f32 top-10
    overlap over 256 rows on the served table and on a random one of the
    same shape."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.ops.quantize import int8_scores

    cached, dev = it["cached"], it["table"].device
    values, scales = cached.q_values, cached.q_scales
    n = cached.n
    rows = np.arange(0, n, n // 64)[:64]
    q = torch.as_tensor(cached.unit_host[rows])
    got = int8_scores(values, scales, q.to(dev))[:, :n]
    want = int8_scores(values.cpu(), scales.cpu(), q)[:, :n]
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"int8 scores on the card differ from the "
                             f"CPU's in {int((got.cpu() != want).sum())} "
                             f"entries")
    gw, gn = torch.topk(got, QUERY_K, dim=1)
    ww, wn = torch.topk(want, QUERY_K, dim=1)
    if not torch.equal(gw.cpu(), ww):
        raise AssertionError("int8 top-k scores differ between card and CPU")
    for i in range(len(rows)):
        for score in ww[i].unique()[1:]:          # the lowest may be cut
            if set(gn[i][gw[i] == score].tolist()) != set(
                    wn[i][ww[i] == score].tolist()):
                raise AssertionError(f"int8 top-k ids of row {rows[i]} "
                                     f"differ beyond ties")
    log(f"int8 scores of {len(rows)} rows x {n} tracks: card == CPU bit "
        f"for bit; top-{QUERY_K} ids equal up to ties")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    int8_index = serve_mod.EmbeddingIndex(tr_st.emb, quantized=True,
                                          device=dev)
    torch.cuda.synchronize()
    int8_bytes = torch.cuda.memory_allocated() - base
    f32_index = serve_mod.EmbeddingIndex(tr_st.emb, device=dev)
    torch.cuda.synchronize()
    f32_bytes = torch.cuda.memory_allocated() - base - int8_bytes
    log(f"int8 index: {int8_bytes} device bytes vs f32 {f32_bytes} "
        f"({f32_bytes / int8_bytes:.2f}x)")
    out = {"int8_scores_bit_equal_rows": len(rows),
           "int8_device_bytes": int8_bytes, "f32_device_bytes": f32_bytes}
    # the overlap on the served embeddings, and on a random unit table of
    # the same shape: int8 resolves cosines ~1e-3 apart, not ~1e-6
    random = np.random.default_rng(9).normal(
        size=tr_st.emb.shape).astype(np.float32)
    for name, pair in (("trained", (int8_index, f32_index)),
                       ("random", tuple(serve_mod.EmbeddingIndex(
                           random, quantized=q, device=dev)
                           for q in (True, False)))):
        out[f"top10_{name}"] = top10_overlap(pair, n)
        log(f"int8 vs f32 top-{QUERY_K} on the {name} table: "
            f"{out[f'top10_{name}']}")
    return out


def top10_overlap(indexes, n: int) -> dict:
    """The int8 index's top-10 against the f32 index's over 256 rows, with
    the f32 lists' mean 1st and 10th cosines and the mean gap from the
    10th to the 11th, the margin int8 rounding has to keep."""
    import numpy as np

    rows = np.arange(0, n, n // 256)[:256]
    a, b = (ix.knn_rows(rows, QUERY_K + 1) for ix in indexes)
    return {
        "overlap": float(np.mean([
            len({o["index"] for o in x[:QUERY_K]}
                & {o["index"] for o in y[:QUERY_K]}) / QUERY_K
            for x, y in zip(a, b)])),
        "f32_cos_1st": float(np.mean([y[0]["score"] for y in b])),
        "f32_cos_10th": float(np.mean([y[QUERY_K - 1]["score"] for y in b])),
        "f32_gap_10th_11th": float(np.mean([
            y[QUERY_K - 1]["score"] - y[QUERY_K]["score"] for y in b])),
    }


def measure_k1(torch, walk_kernel, tables, shapes, launches) -> dict:
    """K1 at each of ``shapes`` ((name, origins, alpha, uniforms)):
    ``torch.equal`` to its plain version, then its device time, its time
    per call as the host launches it, its plain version's time and its
    byte bound."""
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        walks_from_fused_tables,
    )

    origin_ext, i2c_ext, c2i_ext = tables
    rows, err = [], 0
    for name, nodes, alpha, uniforms in shapes:
        hops, b = uniforms.shape[:2]
        got = walk_kernel.restart_walks(tables, nodes, hops, alpha, uniforms)
        want = walks_from_fused_tables(tables, nodes, hops, alpha, uniforms)
        err = max(err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 trace differs from the plain walker "
                                 f"at {name}: {int((got != want).sum())} "
                                 f"entries")

        def run():
            return walk_kernel.walk_hops_cuda(tables, nodes, uniforms, alpha)

        row = {"shape": name, "ms": cuda_ms(torch, run, reps=50),
               "host_ms": cuda_ms(torch, run, reps=50, queued=False),
               "plain_ms": cuda_ms(torch, lambda: walks_from_fused_tables(
                   tables, nodes, hops, alpha, uniforms), reps=3, warmup=1)}
        nbytes = (uniforms.numel() * 4 + hops * b * 4 + b * 4
                  + min(origin_ext.numel() * 4, b * 8)
                  + min(i2c_ext.numel() * 4, hops * b * 8)
                  + min(c2i_ext.numel() * 4, hops * b * 12))
        row["bound_ms"] = nbytes / H100_HBM_BYTES * 1e3
        log(f"K1 at {name}: == plain walker; {json.dumps(row)}")
        rows.append(row)
    main = rows[0]
    return {
        "name": "K1 restart-walk hop (walk_kernel.restart_walks)",
        "route": "cuda", "source": walk_kernel.SOURCE,
        "replaces": walk_kernel.REPLACES,
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": float(err),
        **{key: main[key] for key in ("ms", "host_ms", "plain_ms",
                                      "bound_ms")},
        "bound_by": "bytes", "library_ms": None,
        "shape": main["shape"], "shapes": rows,
    }


def measure_k4(torch, quant_kernel, table, stochastic, launches) -> dict:
    """K4 on the served table: ``torch.equal`` to its plain version
    (values and scales), the contract of tests/test_quantize.py:40-48
    (scales of ``quantize_rows`` at rtol 1e-6, at most one level from
    it, mean dequantization error below 1e-4), and its times."""
    from gcn_song_embeddings_tpu_torch.ops.quantize import quantize_rows

    values, scales = stochastic
    pv, ps = quant_kernel.quantize_rows_stochastic_plain(table, QUANT_SEED)
    if not (torch.equal(values, pv) and torch.equal(scales, ps)):
        raise AssertionError(f"K4 differs from its plain version: "
                             f"{int((values != pv).sum())} values, "
                             f"{int((scales != ps).sum())} scales")
    dv, ds = quantize_rows(table)
    if not torch.allclose(scales, ds, rtol=1e-6, atol=0):
        raise AssertionError("K4 scales differ from quantize_rows'")
    moved = (values.int() - dv.int()).abs()
    bias = float((values.float() * scales[:, None] - table).mean())
    if int(moved.max()) > 1 or not abs(bias) < 1e-4:
        raise AssertionError(f"K4 contract: max level move "
                             f"{int(moved.max())}, mean error {bias}")
    n, d = table.shape
    share = float((moved != 0).float().mean())
    log(f"K4 at {n} x {d} (seed {QUANT_SEED}): == plain version; scales == "
        f"quantize_rows' ({bool(torch.equal(scales, ds))}); "
        f"{share:.4f} of the levels moved one step from round-to-nearest; "
        f"mean dequantization error {bias:.3g}")
    nbytes = 4.0 * n * d + 1.0 * n * d + 4.0 * n
    return {
        "name": "K4 stochastic int8 row quantizer "
                "(quant_kernel.quantize_rows_stochastic)",
        "route": "cuda", "source": quant_kernel.SOURCE,
        "replaces": quant_kernel.REPLACES,
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": float(max(int((values.int() - pv.int()).abs().max()),
                                 float((scales - ps).abs().max()))),
        "ms": cuda_ms(torch, lambda: quant_kernel.quantize_rows_cuda(
            table, QUANT_SEED), reps=50),
        "host_ms": cuda_ms(torch, lambda: quant_kernel.quantize_rows_cuda(
            table, QUANT_SEED), reps=50, queued=False),
        "plain_ms": cuda_ms(torch, lambda: quant_kernel.
                            quantize_rows_stochastic_plain(table, QUANT_SEED),
                            reps=5),
        "bound_ms": nbytes / H100_HBM_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "levels_moved_share": share, "mean_dequant_error": bias,
        "shape": f"the served unit table, N={n} d={d}, seed {QUANT_SEED}",
    }


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_main_path(dev, work: str, n_tracks: int = N_TRACKS,
                  n_collections: int = N_COLLECTIONS,
                  n_positives: int = N_POSITIVES,
                  feature_dim: int = FEATURE_DIM):
    """The port's main path, as a user runs it: dataset -> graph ->
    co-listen augmentation -> PPR sweep -> embed_all -> emb.npy -> hybrid
    HTTP serving (live-walk and cached-head).  Returns its state."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.config import RunConfig
    from gcn_song_embeddings_tpu_torch.data.device import (
        DeviceGraph,
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.data.synth import (
        make_synthetic_dataset,
    )
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        embed_all,
        init_pinsage,
    )
    from gcn_song_embeddings_tpu_torch.ops import walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods,
    )

    shutil.rmtree(work, ignore_errors=True)
    ds = os.path.join(work, "dataset")
    t = time.perf_counter()
    make_synthetic_dataset(ds, n_tracks=n_tracks, n_collections=n_collections,
                           tracks_per_collection=TRACKS_PER_COLLECTION,
                           n_positives=n_positives, feature_dim=feature_dim,
                           seed=0)
    walls = {"make_dataset_s": time.perf_counter() - t}
    log(f"dataset: {n_tracks} tracks, {n_collections} collections x "
        f"{TRACKS_PER_COLLECTION}, {n_positives} positives, "
        f"{feature_dim}-d features in {walls['make_dataset_s']:.1f} s")

    cfg = RunConfig.recommended()
    mcfg = cfg.model
    t = time.perf_counter()
    graph = SongGraph(ds, features_file=os.path.join(ds, "features.npy"))
    train_pos, _ = graph.load_positives_split(
        os.path.join(ds, "positives.json"))
    dg, nb_path = apply_colisten_config(DeviceGraph.from_graph(graph, dev),
                                        train_pos, cfg.walk,
                                        graph.nbhds_path)
    sync(torch, dev)
    walls["load_graph_s"] = time.perf_counter() - t

    t = time.perf_counter()
    nb_w, nb_n = precompute_neighborhoods(dg, cfg.walk, nb_path, seed=0)
    walls["sweep_s"] = time.perf_counter() - t
    sweep_walk_launches = walk_kernel.launches
    log(f"sweep: {graph.n_items} origins x {cfg.walk.n_hops} hops over "
        f"{dg.n_edges} directed edges (co-listen augmented) in "
        f"{walls['sweep_s']:.3f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_pinsage(gen, mcfg.n_layers, graph.features.shape[1],
                          mcfg.hidden_dim, mcfg.out_dim, mcfg.bias_init)
    feats = torch.as_tensor(graph.features, device=dev)
    nbw_d = torch.as_tensor(nb_w, device=dev)
    nbn_d = torch.as_tensor(nb_n, device=dev)
    sync(torch, dev)
    t = time.perf_counter()
    emb_d = embed_all(params, feats, nbw_d, nbn_d, graph.n_items,
                      mcfg.n_layers, mcfg.T)
    sync(torch, dev)
    walls["embed_s"] = time.perf_counter() - t
    emb = emb_d.cpu().numpy()
    emb_path = os.path.join(work, "emb.npy")
    np.save(emb_path, emb)
    log(f"embed: {emb.shape} in {walls['embed_s']:.3f} s -> {emb_path}")

    rows = [3, 17, n_tracks // 2, n_tracks - 1]
    t = time.perf_counter()
    live = serve_mod.HybridIndex(
        np.load(emb_path), DeviceGraph.from_graph(graph, dev),
        train_pairs=train_pos, colisten_copies=cfg.walk.colisten_copies,
        n_hops=SERVE_HOPS, track_ids=graph.track_ids,
        tracks_meta=graph.tracks, device=dev)
    walls["live_index_build_s"] = time.perf_counter() - t
    walls["live"] = serve_queries(serve_mod.serve, live, graph, rows)
    cached = serve_mod.HybridIndex(
        np.load(emb_path), nbhds=(nb_w, nb_n), track_ids=graph.track_ids,
        tracks_meta=graph.tracks, device=dev)
    walls["cached"] = serve_queries(serve_mod.serve, cached, graph, rows)
    sync(torch, dev)
    return SimpleNamespace(
        ds=ds, cfg=cfg, graph=graph, dg=dg, nb_w=nb_w, nb_n=nb_n,
        params=params, feats=feats, nbw_d=nbw_d, nbn_d=nbn_d, emb=emb,
        rows=rows, cached=cached, train_pos=train_pos, walls=walls,
        sweep_walk_launches=sweep_walk_launches)


def train_config(work: str):
    """``RunConfig.recommended()`` at full width, cut to 2 epochs x 25
    batches in chunks of 20, written where ``cli train --config`` reads
    it."""
    import dataclasses

    from gcn_song_embeddings_tpu_torch.config import RunConfig

    cfg = RunConfig.recommended("smoke")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, epochs=TRAIN_EPOCHS, batches_per_epoch=TRAIN_BATCHES,
        checkpoint_every_batches=TRAIN_CHUNK))
    path = os.path.join(work, "train_config.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return cfg, path


def run_train_path(dev, st, work: str):
    """The training path, as a user runs it: ``cli train`` on the main
    path's dataset (its cached sweep is reused), then the trained
    ``emb.npy`` served through the cached-head hybrid.  Returns its
    state."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch import serve as serve_mod

    cfg, cfg_path = train_config(work)
    runs = os.path.join(work, "runs")
    t = time.perf_counter()
    cli.main(["train", "--dataset", st.ds, "--run-dir", runs,
              "--run-name", cfg.run_name, "--config", cfg_path,
              "--device", str(dev)])
    sync(torch, dev)
    walls = {"train_s": time.perf_counter() - t}
    run_dir = os.path.join(runs, cfg.run_name)
    emb_path = os.path.join(run_dir, "emb.npy")
    index = serve_mod.HybridIndex(
        np.load(emb_path), nbhds=(st.nb_w, st.nb_n),
        track_ids=st.graph.track_ids, tracks_meta=st.graph.tracks,
        device=dev)
    walls["trained_cached"] = serve_queries(serve_mod.serve, index,
                                            st.graph, st.rows)
    sync(torch, dev)
    return SimpleNamespace(cfg=cfg, run_dir=run_dir, emb=np.load(emb_path),
                           n_items=st.graph.n_items, walls=walls)


def check_training_run(tr_st) -> None:
    """The run's output and metrics: finite embeddings of every track, 50
    finite metric rows, a falling loss, the rate stepping x0.95 at the
    epoch boundary."""
    import numpy as np

    with open(os.path.join(tr_st.run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    total = TRAIN_EPOCHS * TRAIN_BATCHES
    if tr_st.emb.shape != (tr_st.n_items, tr_st.cfg.model.out_dim) or not (
            np.isfinite(tr_st.emb).all()):
        raise AssertionError(f"trained embeddings: shape {tr_st.emb.shape}, "
                             f"finite {np.isfinite(tr_st.emb).all()}")
    if len(rows) != total:
        raise AssertionError(f"metrics.jsonl has {len(rows)} rows, "
                             f"expected {total}")
    loss = np.array([r["Train Loss"] for r in rows])
    gnorm = np.array([r["Gradient Norm"] for r in rows])
    rate = np.array([r["Learning Rate"] for r in rows])
    if not (np.isfinite(loss).all() and np.isfinite(gnorm).all()):
        raise AssertionError("non-finite loss or gradient norm")
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    log(f"train: loss first 10 {first:.5f} -> last 10 {last:.5f}, grad "
        f"norm {gnorm[0]:.4g} -> {gnorm[-1]:.4g}, rate {rate[0]:.6g} -> "
        f"{rate[-1]:.6g}")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    lr = tr_st.cfg.train.lr
    if not (np.allclose(rate[:TRAIN_BATCHES], lr, rtol=1e-6)
            and np.allclose(rate[TRAIN_BATCHES:], lr * tr_st.cfg.train.decay,
                            rtol=1e-6)):
        raise AssertionError(f"rate does not step at batch "
                             f"{TRAIN_BATCHES}: {rate.tolist()}")
    if [r["epoch"] for r in rows] != [e for e in range(TRAIN_EPOCHS)
                                      for _ in range(TRAIN_BATCHES)]:
        raise AssertionError("metrics rows carry the wrong epochs")


def three_step_checks(torch, trainer) -> dict:
    """3 steps from the trainer's seeded init on the same batches.

    Full-graph forward (K2 + backward) against the frontier forward (K3)
    on the card: every parameter at rtol 1e-4 / atol 1e-5.  The card
    against the CPU's plain versions: the per-step losses at rtol 1e-4,
    G1_w at rtol 1e-4 / atol 1e-5 and the embeddings of 64 nodes at rtol
    1e-3 / atol 1e-4 (tests/test_trainer.py's comparison); every leaf's
    difference is logged.  The two devices round the recomputed
    ``pre = h[nb] Wq^T + bq`` differently, so entries of ``pre`` within an
    ulp of 0 take the other leaky_relu slope, and Adam's normalisation
    turns those gradient differences into visible ones in the deepest
    layer's Wq and bq; the count of such entries at step 1 is logged.
    Returns the largest differences."""
    import copy

    import numpy as np

    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        init_pinsage,
        pinsage_forward,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        TrainTables,
        make_optimizer,
        train_step,
    )

    tcfg, mcfg = trainer.cfg.train, trainer.cfg.model
    gen = block_generator(12345, 0, trainer.device)
    batches = [trainer.sample(gen) for _ in range(3)]
    # the trainer's own init (train.seed), as tests/test_trainer.py starts
    # both of its runs
    seeded = torch.Generator(device=trainer.device)
    seeded.manual_seed(tcfg.seed)
    init = init_pinsage(seeded, mcfg.n_layers, mcfg.in_dim, mcfg.hidden_dim,
                        mcfg.out_dim, mcfg.bias_init)
    probe = torch.arange(0, trainer.n, trainer.n // 64)[:64]

    def run(params, tables, batches, fullgraph):
        opt = make_optimizer(params, tcfg)
        losses = [float(train_step(params, opt, b, tables, tcfg, mcfg,
                                   fullgraph)[0]) for b in batches]
        with torch.inference_mode():
            emb = pinsage_forward(params, tables.features, tables.nbhd_w,
                                  tables.nbhd_n,
                                  probe.to(tables.features.device),
                                  mcfg.n_layers, mcfg.T).cpu().numpy()
        leaves = {name: p.detach().cpu().numpy()
                  for name, p in params.leaves()}
        return losses, leaves, emb

    before = agg.backward_launches["stream"]
    on = run(copy.deepcopy(init), trainer.tables, batches, True)
    sync(torch, trainer.device)
    out = {"k2_backward_launches": agg.backward_launches["stream"] - before}
    if out["k2_backward_launches"] == 0:
        raise AssertionError("the full-graph steps never ran K2's backward")
    off = run(copy.deepcopy(init), trainer.tables, batches, False)
    cpu_tables = TrainTables(*(t.cpu() for t in trainer.tables))
    cpu = run(copy.deepcopy(init).cpu(), cpu_tables,
              [b.cpu() for b in batches], False)
    for name, a, b, held in (("fullgraph_on_vs_off", on, off, None),
                             ("gpu_vs_cpu", off, cpu, ("G1_w",))):
        worst = {leaf: float(np.abs(a[1][leaf] - b[1][leaf]).max())
                 for leaf in a[1]}
        log(f"three steps, {name}: losses {a[0]} vs {b[0]}; max |diff| per "
            f"leaf {worst}")
        np.testing.assert_allclose(a[0], b[0], rtol=TRAJ["rtol"],
                                   err_msg=f"{name}: losses")
        for leaf in held or a[1]:
            np.testing.assert_allclose(a[1][leaf], b[1][leaf], **TRAJ,
                                       err_msg=f"{name}: {leaf}")
        np.testing.assert_allclose(a[2], b[2], rtol=1e-3, atol=1e-4,
                                   err_msg=f"{name}: embeddings")
        out[name] = worst
        log(f"three steps, {name}: held, max |diff| "
            f"{max(worst.values()):.3g}")

    # entries of the deepest conv's pre whose sign the two devices'
    # rounding disagrees on, at step 1
    layer, table, ids, _, _ = step_conv_inputs(torch, trainer,
                                               batches[0])[0]
    Wq, bq = init.layers[0].Wq.detach(), init.layers[0].bq.detach()
    with torch.no_grad():
        rows = table[ids.reshape(-1).long()]
        pre_gpu = torch.addmm(bq, rows, Wq.t()) >= 0
        pre_cpu = torch.addmm(bq.cpu(), rows.cpu(), Wq.t().cpu()) >= 0
    out["leaky_slope_flips_step1"] = int((pre_gpu.cpu() != pre_cpu).sum())
    log(f"three steps: {out['leaky_slope_flips_step1']} of "
        f"{pre_cpu.numel()} entries of the deepest conv's pre change sign "
        f"between the card's and the CPU's rounding at step 1")
    return out


def step_conv_inputs(torch, trainer, batch):
    """The two aggregations of one frontier train step on ``batch``, with
    the step's own tables: (layer, table, ids, weights) for the deepest
    conv (3B(T+1) nodes over the gathered feature rows) and the top conv
    (3B nodes over the deepest conv's output)."""
    from gcn_song_embeddings_tpu_torch.models.pinsage import conv_from_table

    mcfg, tables = trainer.cfg.model, trainer.tables
    T = mcfg.T
    nodes = torch.cat([batch[:, 0], batch[:, 1], batch[:, 2]]).long()
    f1 = torch.cat([nodes, tables.nbhd_n[nodes, :T].reshape(-1).long()])
    f2 = torch.cat([f1, tables.nbhd_n[f1, :T].reshape(-1).long()])

    def ids(m):
        return (m + torch.arange(m * T, dtype=torch.int32,
                                 device=nodes.device)).reshape(m, T)

    table0 = tables.features[f2]
    w0 = tables.nbhd_w[f1, :T].contiguous()
    w1 = tables.nbhd_w[nodes, :T].contiguous()
    layer0, layer1 = trainer.params.layers[0], trainer.params.layers[1]
    with torch.no_grad():
        table1 = conv_from_table(layer0, table0[:len(f1)], table0,
                                 ids(len(f1)), w0, mode="dma")
    return [(layer0, table0, ids(len(f1)), w0, False),
            (layer1, table1, ids(len(nodes)), w1, True)]


def agg_work(torch, nb_idx, nb_wt, din: int, hdim: int, n_rows: int,
             backward: bool = False, need_dh: bool = False):
    """(operations, bytes) the aggregation needs on this data: each
    distinct weighted id projected once (+bq, leaky_relu), each weighted
    entry's multiply-add, one divide per output; inputs read once, output
    written once.  The backward recomputes the projection of the distinct
    rows, forms dWq (and dh) from them, and reads the forward's inputs
    plus the incoming gradient."""
    b, t = nb_idx.shape
    live = nb_wt != 0
    distinct = int(nb_idx[live].unique().numel())
    entries = int(live.sum())
    if not backward:
        flops = (2.0 * distinct * (din + 1) * hdim + 2.0 * entries * hdim
                 + b * hdim)
        nbytes = 4.0 * (distinct * din + 2 * b * t + hdim * din + hdim
                        + b * hdim)
        return flops, nbytes, distinct, entries
    products = 3 if need_dh else 2
    flops = (products * 2.0 * distinct * din * hdim
             + 4.0 * entries * hdim)
    nbytes = 4.0 * (distinct * din + 2 * b * t + hdim * din + hdim
                    + b * hdim + hdim * din + hdim
                    + (n_rows * din if need_dh else 0))
    return flops, nbytes, distinct, entries


def bound(flops: float, nbytes: float, products: float = 0.0):
    """(ms, what bounds it): the larger of the bytes over HBM's rate and
    the operations over the peak rate of their type: ``products`` (of
    ``flops``) on the TF32 tensor cores, three passes each (3xTF32), the
    rest as f32 outside them."""
    ops_ms = (3.0 * products / H100_TF32_FLOPS
              + (flops - products) / H100_FP32_FLOPS) * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def float64_error(torch, agg, h, ids, wts, Wq, bq, got, plain):
    """Max |error| of the kernel's and the plain f32 version's outputs
    against the aggregation in float64 (each table row projected once,
    the T weighted rows summed one at a time, so no [B, T, H] tensor)."""
    proj = agg.project_table_plain(h.double(), Wq.double(), bq.double())
    w64 = wts.double()
    ref = torch.zeros(got.shape, dtype=torch.float64, device=got.device)
    for t in range(ids.shape[1]):
        ref += w64[:, t, None] * proj[ids[:, t].long()]
    del proj
    w_sum = w64.sum(dim=1, keepdim=True)
    ref /= torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)
    return (float((got.double() - ref).abs().max()),
            float((plain.double() - ref).abs().max()))


def k2_parts(torch, agg, h, ids, wts, Wq, bq, got) -> dict:
    """K2's three kernels, each held against its plain version and timed
    beside it: the Wq split (bit for bit), the projection and the
    gather-mean (max |diff|; the gather against ``gather_mean_plain`` of
    the kernel's own projection)."""
    hdim = Wq.shape[0]
    big, small = agg.split_wq(Wq)
    want = [agg.tile_wq_plain(x) for x in agg.tf32_split(Wq)]
    if not (torch.equal(big.view(torch.int32), want[0].view(torch.int32))
            and torch.equal(small.view(torch.int32),
                            want[1].view(torch.int32))):
        raise AssertionError("the Wq split kernel differs from tf32_split")
    proj = agg.project_table(h, big, small, bq)
    rows = agg.slabs_to_rows(proj, hdim)
    proj_err = float((rows - agg.project_table_plain(h, Wq, bq))
                     .abs().max())
    out = torch.empty_like(got)
    mean = agg.gather_mean(proj, ids, wts, out)
    mean_err = float((mean - agg.gather_mean_plain(rows, ids, wts))
                     .abs().max())
    if not (proj_err <= K2_ATOL and mean_err <= K2_ATOL
            and torch.equal(mean, got)):
        raise AssertionError(f"K2 parts: projection {proj_err}, "
                             f"gather-mean {mean_err}")
    return {
        "split": {"max_abs_err": 0.0,
                  "ms": cuda_ms(torch, lambda: agg.split_wq(Wq), reps=10),
                  "plain_ms": cuda_ms(torch, lambda: [
                      agg.tile_wq_plain(x) for x in agg.tf32_split(Wq)],
                      reps=3)},
        "project": {"max_abs_err": proj_err,
                    "ms": cuda_ms(torch, lambda: agg.project_table(
                        h, big, small, bq), reps=5),
                    "plain_ms": cuda_ms(torch, lambda: agg.
                                        project_table_plain(h, Wq, bq),
                                        reps=3)},
        "gather_mean": {"max_abs_err": mean_err,
                        "ms": cuda_ms(torch, lambda: agg.gather_mean(
                            proj, ids, wts, out), reps=5),
                        "plain_ms": cuda_ms(torch, lambda: agg.
                                            gather_mean_plain(rows, ids,
                                                              wts), reps=3)},
    }


def backward_timing(torch, agg, mode, layer, table, ids, wts, need_dh):
    """(relative Frobenius errors, the plain version's own errors, ms,
    plain ms) of the aggregation's backward at one shape, the errors per
    gradient against autograd through the plain version in float64, with
    the inputs that need a gradient in the train step (Wq and bq; h too
    where it is an activation)."""
    def leaves(dtype):
        # copies: the table may be an inference-mode tensor
        h = table.detach().to(dtype, copy=True).requires_grad_(need_dh)
        Wq = layer.Wq.detach().to(dtype, copy=True).requires_grad_()
        bq = layer.bq.detach().to(dtype, copy=True).requires_grad_()
        return h, Wq, bq, ((h, Wq, bq) if need_dh else (Wq, bq))

    gen = torch.Generator(device=table.device)
    gen.manual_seed(7)
    cot = torch.randn((ids.shape[0], layer.Wq.shape[0]),
                      device=table.device, generator=gen)
    h, Wq, bq, inputs = leaves(torch.float64)
    ref = torch.autograd.grad(
        agg.conv_aggregate_plain(h, ids, wts.double(), Wq, bq), inputs,
        cot.double())
    h, Wq, bq, inputs = leaves(torch.float32)
    out = agg.conv_aggregate(h, ids, wts, Wq, bq, mode=mode)
    plain = agg.conv_aggregate_plain(h, ids, wts, Wq, bq)
    got = torch.autograd.grad(out, inputs, cot, retain_graph=True)
    want = torch.autograd.grad(plain, inputs, cot, retain_graph=True)

    def error(grads):
        return [float(torch.linalg.vector_norm(g.double() - r)
                      / torch.linalg.vector_norm(r))
                for g, r in zip(grads, ref)]

    err, plain_err = error(got), error(want)
    del ref, got, want
    ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, inputs, cot, retain_graph=True), reps=5)
    plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        plain, inputs, cot, retain_graph=True), reps=3)
    return err, plain_err, ms, plain_ms


def measure_aggregation(torch, agg, mode, shapes, with_backward=True):
    """Hold the aggregation of ``mode`` against its plain version at each
    (layer, table, ids, weights, need_dh) of ``shapes`` and time it:
    forward (kernel, plain, gather + einsum yardstick; max |diff| within
    K2_ATOL) and backward (ConvAggregate's and autograd through the plain
    version, both held against float64 autograd), summed over the shapes,
    with the work each needs on this data, and each output's max error
    against float64.  Mode "stream" also times the project-once library
    yardstick and holds K2's three kernels to their plain versions
    (``parts``)."""
    import torch.nn.functional as F

    out = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
           "products": 0.0, "bytes": 0.0, "err": 0.0, "err64": 0.0,
           "plain_err64": 0.0, "bwd_ms": 0.0, "bwd_plain_ms": 0.0,
           "bwd_flops": 0.0, "bwd_bytes": 0.0, "bwd_err": 0.0,
           "bwd_plain_err": 0.0}
    if mode == "stream":
        out["library_project_once_ms"] = 0.0
        out["parts"] = {}
    kernel = agg.MODES[mode]
    for layer, h, ids, wts, need_dh in shapes:
        Wq, bq = layer.Wq.detach(), layer.bq.detach()
        n, din = h.shape
        hdim = Wq.shape[0]
        with torch.inference_mode():
            got = agg.conv_aggregate(h, ids, wts, Wq, bq, mode=mode)
            want = agg.conv_aggregate_plain(h, ids, wts, Wq, bq)
            err = float((got - want).abs().max())
            log(f"{kernel} B={ids.shape[0]} T={ids.shape[1]} Din={din} "
                f"H={hdim} (table {n} rows): max |diff| {err:.3g}")
            if not err <= K2_ATOL:
                raise AssertionError(f"{kernel} differs from the plain "
                                     f"version by {err} > {K2_ATOL}")
            out["err"] = max(out["err"], err)
            err64, plain_err64 = float64_error(torch, agg, h, ids, wts, Wq,
                                               bq, got, want)
            log(f"{kernel} max |error| against float64: kernel "
                f"{err64:.3g}, plain f32 version {plain_err64:.3g}")
            out["err64"] = max(out["err64"], err64)
            out["plain_err64"] = max(out["plain_err64"], plain_err64)
            del got, want
            out["ms"] += cuda_ms(torch, lambda: agg.conv_aggregate(
                h, ids, wts, Wq, bq, mode=mode), reps=5)
            out["host_ms"] += cuda_ms(torch, lambda: agg.conv_aggregate(
                h, ids, wts, Wq, bq, mode=mode), reps=5, queued=False)
            out["plain_ms"] += cuda_ms(torch, lambda: agg.conv_aggregate_plain(
                h, ids, wts, Wq, bq), reps=3)
            out["library_ms"] += cuda_ms(torch, lambda: torch.einsum(
                "btd,hd->bth", h[ids.long()], Wq), reps=3)
            if mode == "stream":
                out["library_project_once_ms"] += cuda_ms(
                    torch, lambda: project_once_library(torch, F, h, ids, wts,
                                                        Wq, bq), reps=3)
                got = agg.conv_aggregate(h, ids, wts, Wq, bq, mode=mode)
                for name, part in k2_parts(torch, agg, h, ids, wts, Wq, bq,
                                           got).items():
                    acc = out["parts"].setdefault(
                        name, {"max_abs_err": 0.0, "ms": 0.0,
                               "plain_ms": 0.0})
                    acc["max_abs_err"] = max(acc["max_abs_err"],
                                             part["max_abs_err"])
                    acc["ms"] += part["ms"]
                    acc["plain_ms"] += part["plain_ms"]
        flops, nbytes, distinct, entries = agg_work(torch, ids, wts, din,
                                                    hdim, n)
        out["flops"] += flops
        out["products"] += 2.0 * distinct * din * hdim
        out["bytes"] += nbytes
        log(f"{kernel} work: {distinct} distinct weighted ids of "
            f"{ids.numel()} entries ({entries} weighted)")
        if not with_backward:
            continue
        errs, plain_errs, ms, plain_ms = backward_timing(
            torch, agg, mode, layer, h, ids, wts, need_dh)
        names = ("dh", "dWq", "dbq") if need_dh else ("dWq", "dbq")
        log(f"{kernel} backward vs float64 autograd, relative Frobenius "
            f"error: " + ", ".join(
                f"{g} {e:.3g} (f32 plain {p:.3g})"
                for g, e, p in zip(names, errs, plain_errs)))
        if not max(errs) <= GRAD_RTOL:
            raise AssertionError(f"{kernel} backward error {max(errs)} > "
                                 f"{GRAD_RTOL}")
        out["bwd_err"] = max(out["bwd_err"], *errs)
        out["bwd_plain_err"] = max(out["bwd_plain_err"], *plain_errs)
        out["bwd_ms"] += ms
        out["bwd_plain_ms"] += plain_ms
        flops, nbytes, _, _ = agg_work(torch, ids, wts, din, hdim, n,
                                       backward=True, need_dh=need_dh)
        out["bwd_flops"] += flops
        out["bwd_bytes"] += nbytes
    return out


def project_once_library(torch, F, h, ids, wts, Wq, bq):
    """K2's function from library calls, the table projected once:
    ``torch.addmm`` + leaky_relu, then a gather and the weighted mean."""
    proj = F.leaky_relu(torch.addmm(bq, h, Wq.t()), 0.01)
    w_sum = wts.sum(dim=1, keepdim=True)
    denom = torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)
    return torch.einsum("bt,bth->bh", wts,
                        proj[ids.long()]) / denom


def kernel_row(name, source, replaces, launches_by_path, bwd_launches, m,
               shape) -> dict:
    """One entry of the ``kernels`` line, with the backward's numbers
    under ``backward``.  ``bound_ms`` counts the products on the TF32
    tensor cores in three passes; ``bound_f32_simt_ms`` is the bound
    with every operation as f32 outside them."""
    bound_ms, bound_by = bound(m["flops"], m["bytes"], m["products"])
    simt_ms, _ = bound(m["flops"], m["bytes"])
    bwd_bound_ms, bwd_bound_by = bound(m["bwd_flops"], m["bwd_bytes"])
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path, "max_abs_err": m["err"],
        "ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": m["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": m["library_ms"],
        "bound_f32_simt_ms": simt_ms,
        **({"library_project_once_ms": m["library_project_once_ms"]}
           if "library_project_once_ms" in m else {}),
        "max_abs_err_vs_float64": m["err64"],
        "plain_max_abs_err_vs_float64": m["plain_err64"],
        "backward": {
            "route": "plain PyTorch (agg.ConvAggregate.backward)",
            "launches_on_train_path": bwd_launches,
            "rel_err_vs_float64": m["bwd_err"],
            "plain_rel_err_vs_float64": m["bwd_plain_err"],
            "ms": m["bwd_ms"],
            "plain_ms": m["bwd_plain_ms"], "bound_ms": bwd_bound_ms,
            "bound_by": bwd_bound_by, "library_ms": None},
        "shape": shape,
        **({"parts": m["parts"]} if "parts" in m else {}),
    }


def time_train_steps(torch, trainer, reps: int = 10, profiled: int = 5):
    """Frontier train steps at B=128 from a copy of the trainer's params,
    after two warm-up steps: the synchronized wall per step over ``reps``
    steps, then ``torch.profiler`` over ``profiled`` more: device busy time
    per step, the idle share of the profiled wall (the profiler's own host
    cost is in it), device launches per step and the kernels that take the
    most device time.  Returns (ms per step, profile)."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        make_optimizer,
        train_step,
    )

    tcfg, mcfg = trainer.cfg.train, trainer.cfg.model
    params = copy.deepcopy(trainer.params)
    opt = make_optimizer(params, tcfg)
    gen = block_generator(999, 0, trainer.device)
    batches = [trainer.sample(gen) for _ in range(2 + reps + profiled)]

    def run(batches) -> float:
        t = time.perf_counter()
        for b in batches:
            train_step(params, opt, b, trainer.tables, tcfg, mcfg, False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / len(batches)

    run(batches[:2])
    step_ms = run(batches[2:2 + reps])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(batches[2 + reps:])
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total", 0.0) / 1e3 / profiled

    busy = sum(dev_ms(e) for e in device)
    top = sorted(device, key=dev_ms, reverse=True)[:8]
    return step_ms, {
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "device_launches_per_step": sum(e.count for e in device) / profiled,
        "top_kernels_ms_per_step": {e.key[:80]: dev_ms(e) for e in top}}


EVAL_K, EVAL_QUERIES = 100, 256
EVAL_MODELS = ("Random", "Features", "PageRank", "PageRankCo")


def run_eval_path(dev, st, tr_st, work: str):
    """The eval path, as a user runs it: ``SongGraph`` through the native
    ``graph.json`` reader (timed beside the ``json`` module's reading of
    the same file), then ``cli eval`` of the Random, Features, PageRank,
    PageRankCo and trained PinSage rows at K=100 (PageRank walks with
    K1); then the parts of ``eval_s`` outside the rows' own times, timed
    again on its caches (their reads and compressed writes, each table).
    Returns its state."""
    from types import SimpleNamespace

    import numpy as np

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.evals.harness import LazyKnnDict
    from gcn_song_embeddings_tpu_torch.evals.tables import (
        compute_beyond_accuracy_table,
        compute_results_table,
    )
    from gcn_song_embeddings_tpu_torch.native import jsongraph

    ds = st.ds
    walls = {}
    t = time.perf_counter()
    graph = SongGraph(ds, features_file=os.path.join(ds, "features.npy"))
    walls["load_graph_s"] = time.perf_counter() - t
    if graph.edge_reader != "native":
        raise AssertionError(f"graph.json read by {graph.edge_reader!r}, "
                             f"not the native scanner")
    path = os.path.join(ds, "graph.json")
    t = time.perf_counter()
    jsongraph.load_edges(path, graph.index_map)
    walls["native_edges_s"] = time.perf_counter() - t
    t = time.perf_counter()
    src, dst = jsongraph.load_edges_json(path, graph.index_map)
    walls["json_module_edges_s"] = time.perf_counter() - t
    if not (np.array_equal(src, graph._edges_from)
            and np.array_equal(dst, graph._edges_to)):
        raise AssertionError("native and json edge readers disagree")
    log(f"SongGraph ({graph.edge_reader} edges, tracks.json and "
        f"collections.json by the json module, CSR build): "
        f"{walls['load_graph_s']:.3f} s; graph.json's {len(src)} edges: "
        f"native {walls['native_edges_s']:.3f} s, json module "
        f"{walls['json_module_edges_s']:.3f} s")

    run_name = os.path.basename(tr_st.run_dir)
    pinsage = f"PinSage:{run_name}"
    eval_dir = os.path.join(work, "eval")
    t = time.perf_counter()
    cli.main(["eval", "--dataset", ds, "--run-dir",
              os.path.dirname(tr_st.run_dir), "--pinsage-runs", run_name,
              "--k", str(EVAL_K), "--models", *EVAL_MODELS, pinsage,
              "--eval-dir", eval_dir, "--device", str(dev)])
    walls["eval_s"] = time.perf_counter() - t
    models = (*EVAL_MODELS, pinsage)
    # the part of eval_s outside the models' own times, timed again here
    # on the same caches: each kNN cache's read and compressed write, and
    # each table (which reads every cache once)
    walls["knn_cache_read_s"] = walls["knn_cache_write_s"] = 0.0
    for model in models:
        t = time.perf_counter()
        with np.load(os.path.join(eval_dir, "knn", model + ".npz")) as z:
            arrays = dict(z)
        walls["knn_cache_read_s"] += time.perf_counter() - t
        t = time.perf_counter()
        np.savez_compressed(os.path.join(work, "knn_rewrite.npz"), **arrays)
        walls["knn_cache_write_s"] += time.perf_counter() - t
    _, test_pos = graph.load_positives_split(
        os.path.join(ds, "positives.json"))
    knn = LazyKnnDict(list(models), eval_dir)
    t = time.perf_counter()
    compute_results_table(knn, test_pos, graph.in_degrees())
    walls["accuracy_table_s"] = time.perf_counter() - t
    t = time.perf_counter()
    compute_beyond_accuracy_table(knn, test_pos, graph.in_degrees(),
                                  graph.features, device=dev)
    walls["beyond_table_s"] = time.perf_counter() - t
    return SimpleNamespace(graph=graph, eval_dir=eval_dir, pinsage=pinsage,
                           models=models, walls=walls)


def read_csv_rows(path: str) -> dict:
    """A results CSV -> {model: {column: float}}."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {r[0]: {c: float(x) for c, x in zip(rows[0][1:], r[1:])}
            for r in rows[1:]}


def check_eval(torch, dev, ev, tr_st) -> dict:
    """The eval path's outputs: both CSVs hold a finite row per model,
    each kNN cache is [N, 100]; ``rank_eval`` on the card over every test
    pair against the full catalog gives the PinSage row's hit@10 and
    hit@100 within 1e-3 of the list-based table's; the kNN ids of 256
    PinSage queries on the card equal a CPU f32 recompute up to ties
    within 1e-6."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
    from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb

    graph = ev.graph
    tables = {name: read_csv_rows(os.path.join(ev.eval_dir, name))
              for name in ("results_accuracy.csv", "results_beyond.csv")}
    for name, table in tables.items():
        if sorted(table) != sorted(ev.models) or not all(
                np.isfinite(v) for row in table.values()
                for v in row.values()):
            raise AssertionError(f"{name}: rows {list(table)}, not all "
                                 f"finite")
    for model in ev.models:
        with np.load(os.path.join(ev.eval_dir, "knn", model + ".npz")) as z:
            shape = z["knn_n"].shape
        if shape != (graph.n_items, EVAL_K):
            raise AssertionError(f"knn/{model}.npz has shape {shape}")
    acc = tables["results_accuracy.csv"]
    _, test_pos = graph.load_positives_split(
        os.path.join(graph.base_dir, "positives.json"))
    out = {"accuracy": acc, "beyond": tables["results_beyond.csv"],
           "rank_eval": {}}
    for model, emb in ((ev.pinsage, tr_st.emb),
                       ("Features", np.load(os.path.join(
                           graph.base_dir, "features.npy")))):
        sync(torch, dev)
        t = time.perf_counter()
        got = rank_eval(emb, test_pos, device=dev)
        sync(torch, dev)
        got["s"] = time.perf_counter() - t
        diff = {k: abs(got[f"hit@{k}"] - acc[model][f"hr (k={k})"])
                for k in (10, 100)}
        got["diff_vs_lists"] = diff
        out["rank_eval"][model] = got
        log(f"rank_eval {model} over {len(test_pos)} test pairs x "
            f"{graph.n_items} tracks on the card in {got['s']:.3f} s: "
            f"{json.dumps(got)}")
        if model == ev.pinsage and not max(diff.values()) <= 1e-3:
            raise AssertionError(f"rank_eval and the kNN lists disagree "
                                 f"for {model}: {diff}")
    queries = np.arange(0, graph.n_items, graph.n_items // EVAL_QUERIES)
    queries = queries[:EVAL_QUERIES]
    gw, gn = knn_from_emb(tr_st.emb, queries, k=EVAL_K, device=dev)
    cw, cn = knn_from_emb(tr_st.emb, queries, k=EVAL_K, device="cpu")
    # "equal up to ties": in each place the card's id and the CPU's have
    # exact (float64) cosines within 1e-6 of each other, so ids differ
    # only by a swap inside a near-tie (the self-drop's included) or at
    # the list's end
    e = np.asarray(tr_st.emb, dtype=np.float64)
    e = e / np.linalg.norm(e, axis=1, keepdims=True)

    def exact(ids):
        return np.einsum("qd,qkd->qk", e[queries], e[ids])

    score_err = float(np.abs(gw - cw).max())
    own_err = float(np.abs(exact(gn) - exact(cn)).max())
    differ = gn != cn
    if not (score_err <= 1e-6 and own_err <= 1e-6):
        raise AssertionError(f"card kNN differs from the CPU's: scores "
                             f"{score_err}, the card ids' own cosines "
                             f"{own_err}, {int(differ.sum())} ids differ")
    out["knn_card_vs_cpu"] = {"queries": len(queries),
                              "max_score_diff": score_err,
                              "max_own_cosine_diff": own_err,
                              "ids_differing_within_ties": int(differ.sum())}
    log(f"kNN of {len(queries)} PinSage queries, card vs CPU f32: "
        f"{json.dumps(out['knn_card_vs_cpu'])}")
    return out


def check_project_once(torch, agg, st) -> dict:
    """``embed_all`` at N=100k launches K2's projection once per layer;
    with ``block_rows=32_768`` it gathers in 4 blocks a layer and gives
    the same embeddings within 1e-5."""
    from gcn_song_embeddings_tpu_torch.models.pinsage import embed_all

    mcfg = st.cfg.model
    args = (st.params, st.feats, st.nbw_d, st.nbn_d, st.graph.n_items,
            mcfg.n_layers, mcfg.T)
    out = {}
    embs = []
    for block_rows in (131_072, 32_768):
        before = dict(agg.kernel_launches)
        embs.append(embed_all(*args, block_rows=block_rows))
        torch.cuda.synchronize()
        counts = {k: agg.kernel_launches[k] - before[k] for k in before}
        blocks = -(-st.graph.n_items // block_rows)
        if counts != {"split": mcfg.n_layers, "project": mcfg.n_layers,
                      "gather_mean": mcfg.n_layers * blocks}:
            raise AssertionError(f"embed_all at block_rows={block_rows}: "
                                 f"{counts}")
        out[f"block_rows_{block_rows}"] = counts
    out["max_abs_diff"] = float((embs[0] - embs[1]).abs().max())
    log(f"embed_all at N={st.graph.n_items}: {json.dumps(out)}")
    if not out["max_abs_diff"] <= 1e-5:
        raise AssertionError(f"blocked embed_all differs: {out}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        conv_from_table,
        pinsage_forward,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg, cuda_build, dma_agg
    from gcn_song_embeddings_tpu_torch.ops import quant_kernel, walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        block_generator,
        precompute_neighborhoods,
    )
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        draw_uniforms,
        fused_walk_tables,
    )
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer

    dev = torch.device("cuda")
    log(card_line())
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # ---- build ---------------------------------------------------------
    t = time.perf_counter()
    reports = cuda_build.build()
    log(f"build: {len(reports)} kernels in {time.perf_counter() - t:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "bytes stack frame" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    kernels = {"walk": walk_kernel, "agg": agg, "dma_agg": dma_agg,
               "quant": quant_kernel}

    def reset_counts():
        for mod in kernels.values():
            mod.launches = 0
        for counts in (agg.backward_launches, agg.kernel_launches):
            for key in counts:
                counts[key] = 0

    def read_counts(need):
        counts = {name: mod.launches for name, mod in kernels.items()}
        counts.update({f"agg_backward_{mode}": n
                       for mode, n in agg.backward_launches.items()})
        counts.update({f"agg_{name}": n
                       for name, n in agg.kernel_launches.items()})
        missing = [name for name in need if counts[name] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the path: "
                                 f"{missing}")
        return counts

    work = os.path.join(REPO, "build", "chip_smoke")
    reset_counts()
    st = run_main_path(dev, work)
    launches = read_counts(("walk", "agg", "agg_split", "agg_project",
                            "agg_gather_mean"))
    log(f"launches on the main path: {launches}")

    # ---- the training path ---------------------------------------------
    reset_counts()
    tr_st = run_train_path(dev, st, work)
    train_launches = read_counts(("agg", "dma_agg", "agg_backward_dma",
                                  "agg_split"))
    log(f"launches on the training path: {train_launches}")
    check_training_run(tr_st)
    graph, cfg, mcfg = st.graph, st.cfg, st.cfg.model
    trainer = PinSageTrainer(
        DeviceGraph.from_graph(graph, dev), graph.n_items, graph.features,
        st.train_pos, cfg=tr_st.cfg,
        base_run_dir=os.path.dirname(tr_st.run_dir),
        nbhds_path=graph.nbhds_path, log=False, load_save=True,
        verbose=False)
    if (trainer.e, trainer.b, trainer.opt.count) != (
            TRAIN_EPOCHS, 0, TRAIN_EPOCHS * TRAIN_BATCHES):
        raise AssertionError(f"resume: epoch {trainer.e}, batch "
                             f"{trainer.b}, count {trainer.opt.count}")
    resume_err = float(np.abs(trainer.embed() - tr_st.emb).max())
    probe = np.arange(0, graph.n_items, 1571)
    frontier_err = float(np.abs(trainer.embed(ids=probe)
                                - tr_st.emb[probe]).max())
    log(f"resumed trainer (epoch {trainer.e}): embed_all vs the run's "
        f"emb.npy max |diff| {resume_err:.3g}; frontier embed (K3) of "
        f"{len(probe)} rows vs emb.npy (K2) max |diff| {frontier_err:.3g}")
    if not (resume_err <= 1e-6 and frontier_err <= 1e-4):
        raise AssertionError(f"resumed embeddings differ: {resume_err}, "
                             f"{frontier_err}")
    steps = three_step_checks(torch, trainer)
    st.walls.update(tr_st.walls)
    st.walls["train_step_ms"], step_profile = time_train_steps(torch,
                                                                trainer)

    # ---- the eval path, on the trained embeddings -----------------------
    reset_counts()
    ev = run_eval_path(dev, st, tr_st, work)
    eval_launches = read_counts(("walk",))
    log(f"launches on the eval path: {eval_launches}")
    eval_checks = check_eval(torch, dev, ev, tr_st)
    eval_checks["project_once"] = check_project_once(torch, agg, st)
    log(json.dumps({"eval_walls": {
        **ev.walls, "models": {m: {c: eval_checks["accuracy"][m][c]
                                   for c in ("t (train)", "t (emb)",
                                             "t (knn)")}
                               for m in ev.models}}}))

    # ---- the int8 serving path, on the trained embeddings --------------
    reset_counts()
    it = run_int8_path(dev, st, tr_st)
    int8_launches = read_counts(("walk", "quant"))
    log(f"launches on the int8 path: {int8_launches}")
    st.walls["int8"] = it["walls"]
    int8_checks = check_int8(torch, st, tr_st, it)
    log(json.dumps({"phase_walls": st.walls}))
    log(json.dumps({"train_step_profile": step_profile}))
    log(json.dumps({"int8_checks": int8_checks}))
    log(json.dumps({"eval_checks": eval_checks}))
    emb, nb_w, nb_n, params = st.emb, st.nb_w, st.nb_n, st.params
    feats, nbw_d, nbn_d, dg = st.feats, st.nbw_d, st.nbn_d, st.dg
    rows, cached, ds = st.rows, st.cached, st.ds

    # ---- outputs are right ---------------------------------------------
    if emb.shape != (graph.n_items, mcfg.out_dim) or not np.isfinite(
            emb).all():
        raise AssertionError(f"embeddings: shape {emb.shape}, finite "
                             f"{np.isfinite(emb).all()}")
    probe = torch.arange(0, graph.n_items, 1571, dtype=torch.int32)
    with torch.inference_mode():
        ref = pinsage_forward(copy.deepcopy(params).cpu(), feats.cpu(),
                              nbw_d.cpu(), nbn_d.cpu(), probe,
                              mcfg.n_layers, mcfg.T).numpy()
    cpu_err = float(np.abs(emb[probe.numpy()] - ref).max())
    log(f"embed_all (GPU, K2) vs pinsage_forward (CPU, plain) on "
        f"{len(probe)} nodes: max |diff| {cpu_err:.3g}")
    if not cpu_err <= 1e-4:
        raise AssertionError(f"GPU embeddings disagree with the CPU path: "
                             f"{cpu_err}")
    head = cached.knn_rows(np.asarray(rows), QUERY_K)
    for row, nbrs in zip(rows, head):
        lead = [int(n) for n, w in zip(nb_n[row], nb_w[row]) if w > 0]
        got = [o["index"] for o in nbrs][:min(len(lead), QUERY_K)]
        if got != lead[:len(got)]:
            raise AssertionError(f"cached head of row {row}: {got} vs "
                                 f"{lead[:len(got)]}")
    cli_emb = os.path.join(work, "emb_cli.npy")
    cli.main(["embed", "--dataset", ds, "--out", cli_emb, "--seed", "0"])
    cli_err = float(np.abs(np.load(cli_emb) - emb).max())
    log(f"cli embed (cached sweep) vs main path: max |diff| {cli_err:.3g}")
    if not cli_err <= 1e-6:
        raise AssertionError(f"cli embed differs: {cli_err}")

    # the sweep's wall without its compressed .npz cache write
    t = time.perf_counter()
    precompute_neighborhoods(dg, cfg.walk, None, seed=0)
    torch.cuda.synchronize()
    log(f"sweep without the cache write: {time.perf_counter() - t:.3f} s")

    # ---- kernels against their plain versions, at the path's shapes ----
    # K1 at the sweep's shape (alpha 0.85 and 0) and at the live-walk
    # requests' (one query and a batch of 4, SERVE_HOPS hops)
    b, hops, alpha = cfg.walk.batch_walkers, cfg.walk.n_hops, cfg.walk.alpha
    sweep_nodes = torch.arange(b, dtype=torch.int32, device=dev)
    sweep_u = draw_uniforms(hops, b, block_generator(0, 0, dev))
    live = [torch.tensor(rows[:n], dtype=torch.int32, device=dev)
            for n in (1, len(rows))]
    k1_shapes = [(f"sweep B={b} H={hops} alpha={alpha}", sweep_nodes, alpha,
                  sweep_u),
                 (f"sweep B={b} H={hops} alpha=0.0", sweep_nodes, 0.0,
                  sweep_u)]
    for i, nodes in enumerate(live):
        k1_shapes.append((f"live-walk B={len(nodes)} H={SERVE_HOPS} "
                          f"alpha={alpha}", nodes, alpha, draw_uniforms(
                              SERVE_HOPS, len(nodes),
                              block_generator(1, i, dev))))
    # PersPageRank's query block at eval: the harness asks for 1000 rows
    # at a time, each walking SERVE_HOPS hops
    eval_nodes = torch.arange(1000, dtype=torch.int32, device=dev)
    k1_shapes.append((f"eval PageRank B=1000 H={SERVE_HOPS} alpha={alpha}",
                      eval_nodes, alpha, draw_uniforms(
                          SERVE_HOPS, 1000, block_generator(0, 0, dev))))
    sweep_launches = st.sweep_walk_launches
    results = [measure_k1(
        torch, walk_kernel, fused_walk_tables(dg), k1_shapes,
        {"sweep": sweep_launches,
         "live_walk": launches["walk"] - sweep_launches,
         "eval": eval_launches["walk"],
         "int8_live_walk": int8_launches["walk"]})]

    # K2 at both conv layers' shapes of embed_all (its backward at the
    # same shapes: the train step's full-graph forward), K3 at both
    # aggregations of a frontier train step (K2 timed there too)
    nb_idx = nbn_d[:, :mcfg.T].to(torch.int32).contiguous()
    nb_wt = nbw_d[:, :mcfg.T].contiguous()
    with torch.inference_mode():
        h1 = conv_from_table(params.layers[0], feats, feats, nb_idx, nb_wt)
    embed_shapes = [(params.layers[0], feats, nb_idx, nb_wt, False),
                    (params.layers[1], h1, nb_idx, nb_wt, True)]
    k2 = measure_aggregation(torch, agg, "stream", embed_shapes)
    gen = block_generator(4242, 0, dev)
    step_shapes = step_conv_inputs(torch, trainer, trainer.sample(gen))
    k3 = measure_aggregation(torch, agg, "dma", step_shapes)
    k2_at_step = measure_aggregation(torch, agg, "stream", step_shapes,
                                     with_backward=False)
    row = kernel_row(
        "K2 3xTF32 Q-MLP of every table row, then gather + weighted mean "
        "(agg.conv_aggregate, mode stream)", agg.SOURCE, agg.REPLACES,
        {"serve": launches["agg"], "train": train_launches["agg"]},
        train_launches["agg_backward_stream"], k2,
        f"both embed_all layers, N={graph.n_items} T={mcfg.T}: Din=512 and "
        f"Din=128, H={mcfg.hidden_dim}; backward at the same shapes (the "
        f"full-graph train step), launched "
        f"{steps['k2_backward_launches']} times by the three-step check")
    row["header"] = agg.HEADER
    for name, part in row["parts"].items():
        # the split also runs for every K3 call of the training path
        part["launches_by_path"] = {"serve": launches[f"agg_{name}"],
                                    "train": train_launches[f"agg_{name}"]}
    results.append(row)
    row = kernel_row(
        "K3 fused 3xTF32 gather + Q-MLP + weighted mean "
        "(agg.conv_aggregate, mode dma)", dma_agg.SOURCE, dma_agg.REPLACES,
        {"train": train_launches["dma_agg"]},
        train_launches["agg_backward_dma"], k3,
        f"both aggregations of a frontier train step at B=128: "
        f"{step_shapes[0][2].shape[0]} nodes x T={mcfg.T}, Din=512 and "
        f"{step_shapes[1][2].shape[0]} nodes x T={mcfg.T}, Din=128; "
        f"H={mcfg.hidden_dim}")
    row["k2_ms_same_shapes"] = k2_at_step["ms"]
    row["k2_host_ms_same_shapes"] = k2_at_step["host_ms"]
    results.append(row)
    results.append(measure_k4(torch, quant_kernel, it["table"],
                              it["stochastic"],
                              {"int8": int8_launches["quant"]}))
    shutil.rmtree(work, ignore_errors=True)
    log(card_line())
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
