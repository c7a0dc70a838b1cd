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
4. Holds each kernel against its plain PyTorch version on the card at the
   path's shapes (K1 bit-identical, K2 within 1e-4 absolute), and times
   kernel, plain version and a library yardstick with CUDA events.
5. Checks the outputs: finite embeddings of the expected shape that match
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
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12   # f32 outside the tensor cores (data sheet, SXM)
H100_HBM_BYTES = 3.35e12  # HBM3 bytes/s (data sheet, SXM)
K2_ATOL = 1e-4  # f32 sums of Din products in another order: ~1e-6 expected

# the README's 100k scale: ~1M directed playlist edges
N_TRACKS, N_COLLECTIONS, TRACKS_PER_COLLECTION = 100_000, 25_000, 20
N_POSITIVES, FEATURE_DIM = 200_000, 512
SERVE_HOPS, QUERY_K = 1000, 10


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def check_neighbors(nbrs, query_row: int, k: int) -> None:
    ids = [n["index"] for n in nbrs]
    if len(ids) != k or len(set(ids)) != k or query_row in ids:
        raise AssertionError(f"bad neighbor list for row {query_row}: {ids}")
    if not all(isinstance(n["score"], float) for n in nbrs):
        raise AssertionError("non-float scores")


def serve_queries(serve, index, graph, rows) -> dict:
    """Serve ``index`` on 127.0.0.1 in a thread, answer single and batched
    requests, check each response's shape; returns request walls (ms)."""
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
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    return walls


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
        rows=rows, cached=cached, walls=walls)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        conv_from_table,
        pinsage_forward,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg, cuda_build
    from gcn_song_embeddings_tpu_torch.ops import walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        block_generator,
        precompute_neighborhoods,
    )
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        draw_uniforms,
        fused_walk_tables,
        walks_from_fused_tables,
    )

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
    kernels = {"walk": walk_kernel, "agg": agg}

    work = os.path.join(REPO, "build", "chip_smoke")
    for mod in kernels.values():
        mod.launches = 0
    st = run_main_path(dev, work)
    launches = {name: mod.launches for name, mod in kernels.items()}
    log(f"launches on the main path: {launches}")
    log(json.dumps({"phase_walls": st.walls}))
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    graph, cfg, mcfg = st.graph, st.cfg, st.cfg.model
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
    results = []
    tables = fused_walk_tables(dg)
    b, hops = cfg.walk.batch_walkers, cfg.walk.n_hops
    nodeset = torch.arange(b, dtype=torch.int32, device=dev)
    uniforms = draw_uniforms(hops, b, block_generator(0, 0, dev))
    k1_err = 0
    for alpha in (cfg.walk.alpha, 0.0):
        got = walk_kernel.restart_walks(tables, nodeset, hops, alpha,
                                        uniforms)
        want = walks_from_fused_tables(tables, nodeset, hops, alpha,
                                       uniforms)
        k1_err = max(k1_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 trace differs from the plain walker "
                                 f"at alpha={alpha}: "
                                 f"{int((got != want).sum())} entries")
    alpha = cfg.walk.alpha
    origin_ext, i2c_ext, c2i_ext = tables
    k1_bytes = (uniforms.numel() * 4 + hops * b * 4 + b * 4
                + min(origin_ext.numel() * 4, b * 8)
                + min(i2c_ext.numel() * 4, hops * b * 8)
                + min(c2i_ext.numel() * 4, hops * b * 12))
    results.append({
        "name": "K1 restart-walk hop (walk_kernel.restart_walks)",
        "route": "cuda", "source": walk_kernel.SOURCE,
        "replaces": walk_kernel.REPLACES, "launches": launches["walk"],
        "max_abs_err": float(k1_err),
        "ms": cuda_ms(torch, lambda: walk_kernel.walk_hops_cuda(
            tables, nodeset, uniforms, alpha), reps=20),
        "plain_ms": cuda_ms(torch, lambda: walks_from_fused_tables(
            tables, nodeset, hops, alpha, uniforms), reps=3, warmup=1),
        "bound_ms": k1_bytes / H100_HBM_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shape": f"B={b} H={hops} alpha={alpha}",
    })

    # K2 at both conv layers' shapes of embed_all
    nb_idx = nbn_d[:, :mcfg.T].to(torch.int32).contiguous()
    nb_wt = nbw_d[:, :mcfg.T].contiguous()
    with torch.inference_mode():
        h1 = conv_from_table(params.layers[0], feats, feats, nb_idx, nb_wt)
    k2 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
          "bytes": 0.0, "err": 0.0}
    with torch.inference_mode():
        for layer, h in ((params.layers[0], feats), (params.layers[1], h1)):
            Wq, bq = layer.Wq.detach(), layer.bq.detach()
            got = agg.conv_aggregate(h, nb_idx, nb_wt, Wq, bq)
            want = agg.conv_aggregate_plain(h, nb_idx, nb_wt, Wq, bq)
            err = float((got - want).abs().max())
            n, din = h.shape
            hdim = Wq.shape[0]
            log(f"K2 N={n} T={mcfg.T} Din={din} H={hdim}: max |diff| "
                f"{err:.3g}")
            if not err <= K2_ATOL:
                raise AssertionError(f"K2 differs from the plain version "
                                     f"by {err} > {K2_ATOL}")
            k2["err"] = max(k2["err"], err)
            k2["ms"] += cuda_ms(torch, lambda: agg.conv_aggregate(
                h, nb_idx, nb_wt, Wq, bq), reps=5)
            k2["plain_ms"] += cuda_ms(torch, lambda: agg.conv_aggregate_plain(
                h, nb_idx, nb_wt, Wq, bq), reps=3)
            k2["library_ms"] += cuda_ms(torch, lambda: torch.einsum(
                "btd,hd->bth", h[nb_idx.long()], Wq), reps=3)
            # the function's own work on this run's table: each distinct
            # id of a weighted entry projected once (+bq, leaky_relu), each
            # weighted entry's multiply-add, one divide per output
            live = nb_wt != 0
            distinct = int(nb_idx[live].unique().numel())
            entries = int(live.sum())
            k2["flops"] += (2.0 * distinct * (din + 1) * hdim
                            + 2.0 * entries * hdim + n * hdim)
            k2["bytes"] += 4.0 * (distinct * din + 2 * n * mcfg.T
                                  + hdim * din + hdim + n * hdim)
            log(f"K2 work: {distinct} distinct weighted ids of {n * mcfg.T} "
                f"entries ({entries} weighted)")
    results.append({
        "name": "K2 fused gather + Q-MLP + weighted mean (agg.conv_aggregate)",
        "route": "cuda", "source": agg.SOURCE, "replaces": agg.REPLACES,
        "launches": launches["agg"], "max_abs_err": k2["err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": max(k2["flops"] / H100_FP32_FLOPS,
                        k2["bytes"] / H100_HBM_BYTES) * 1e3,
        "bound_by": ("operations" if k2["flops"] / H100_FP32_FLOPS
                     >= k2["bytes"] / H100_HBM_BYTES else "bytes"),
        "library_ms": k2["library_ms"],
        "shape": (f"both embed_all layers, N={graph.n_items} T={mcfg.T}: "
                  f"Din=512 and Din=128, H={mcfg.hidden_dim}"),
    })
    shutil.rmtree(work, ignore_errors=True)
    log(card_line())
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
