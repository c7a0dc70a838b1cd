"""Benchmark: PinSage training throughput on one card, and the FLOP-bound
step against the card's bound.

The port's counterpart of ``bench.py`` at the repository's root, without
JAX.  Prints ONE JSON line on stdout (progress goes to stderr)::

    {"metric": "train_edges_per_s_chip", "value": N, "unit": "edges/s",
     "vs_baseline": R, ...}

* The headline: ``value`` is the edges aggregated per second by the
  trainer's sample + forward + backward + Adam step
  (``train.trainer.train_chunk``) at ``bench.py``'s reference shape
  (B=128, L=2, T=3, hidden 512, out 128, 512-d features over 20,000
  tracks; ``edges_per_step``: 5,760), the frontier forward (K3 and the
  aggregation's plain backward on the card).  The time a batch is
  ``bench.py``'s chunk difference: (wall of a ``--chunk-large`` chunk -
  wall of a ``--chunk-small`` one) / their difference, the median of
  ``--reps``, each wall ending when the chunk's metrics reach the host.
  ``warmup_s`` is the first use's kernel build plus the two warm-up
  chunks; ``kernel_build`` says whether ``build/torch_kernels/`` already
  held the kernels ("cached") or they were built in this run ("built").
* ``vs_baseline``: the torch-CPU re-implementation's time a batch cached
  in ``BENCH_BASELINE.json`` (read, never written) over the card's.
  ``--fresh-baseline`` also measures it on this host
  (``vs_baseline_this_host``).
* The FLOP-bound step (``flopbound_*``): the reference grid's large
  model (L=4, hidden 1024, out 256) at B=4,096 with the full-graph
  forward (K2 and the plain backward), in f32 and in bf16
  (``flopbound_bf16_*``: K2's 16-bit form), as TFLOP/s of ``bench.py``'s
  analytic count and as ``flopbound_mfu_vs_ceiling``: the least time the
  card could take for the products the step's function needs
  (``flopbound_bound_ms``: f32 products at the card's fastest f32-accurate
  rate, 16-bit ones at its bf16 rate) over the measured time.  ``flopbound_contig_step_ms`` is the f32 step with
  contiguous neighbor ids (the exposed-gather control).
* The roofline instruments: the gather's row rate at widths 256, 512 and
  1024 in f32 and 512 in bf16 (``gather_read_probe``, a yardstick
  kernel), the streaming read rate of a 256 MB array
  (``agg.l2_read_probe``) and ``flopbound_roofline_ratio``: the measured
  f32 step over gathers + the step's bound + activation traffic.

::

    python -m gcn_song_embeddings_tpu_torch.bench [--device cpu]
        [--tracks 20000] [--chunk-small 100] [--chunk-large 500]
        [--fb-chunk-small 20] [--fb-chunk-large 100] [--reps 3]
        [--skip-probes] [--fresh-baseline]

Runs on the GPU unless ``--device`` names another device; without a card
it raises.  On the CPU every kernel's plain version runs and the times
are the CPU's (``platform`` says which).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.fullgraph_bench import (
    bench_data,
    chunk_difference,
    edges_per_step,
    positive_median,
    seeded_params,
)
from gcn_song_embeddings_tpu_torch.ops import agg, cuda_build
from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
from gcn_song_embeddings_tpu_torch.scale_demo import platform
from gcn_song_embeddings_tpu_torch.train.trainer import (
    TrainTables,
    make_optimizer,
    train_chunk,
    use_fullgraph,
)
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

N_TRACKS = 20000
N_COLS = 4000
FEAT_DIM = 512
BATCH = 128
N_LAYERS = 2
T = 3
HIDDEN = 512
OUT = 128
CHUNK_SMALL = 100
CHUNK_LARGE = 500
REPS = 3

FB_BATCH = 4096
FB_LAYERS = 4
FB_HIDDEN = 1024
FB_OUT = 256
FB_CHUNK_SMALL = 20
FB_CHUNK_LARGE = 100
# the card's peaks (NVIDIA's H100 SXM data sheet, dense), in place of the
# script's TPU ceiling
H100_FP32_FLOPS = 67e12   # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12  # TF32 tensor cores
H100_HBM_BYTES = 3.35e12  # HBM3 bytes/s
H100_BF16_FLOPS = 989e12  # bf16 tensor cores
# the fastest rate at which the card forms f32-accurate products: three
# TF32 passes over split operands (K2 holds f32 results this way)
F32_PRODUCT_FLOPS = H100_TF32_FLOPS / 3

# HBM passes over the gathered neighbor rows per train step: the forward
# gather, the backward's re-gather of the same rows for dQ, and the
# scatter-accumulate of dh (bench.py's model)
GATHER_PASSES = 3
STREAM_MIB = 256          # the streaming read's array (exceeds the 50 MB L2)
SPIN_CYCLES = 20_000_000  # device_wall's sleep kernel: ~10 ms at 2 GHz

BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BENCH_BASELINE.json")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_problem(seed: int = 0, n_tracks: int = N_TRACKS):
    """``bench.py``'s arrays in its order: (features, nb_w, nb_n,
    positives), the draws of ``fullgraph_bench.bench_data``."""
    features, nb_n, nb_w, positives = bench_data(
        np.random.default_rng(seed), n_tracks, FEAT_DIM)
    return features, nb_w, nb_n, positives


def flopbound_matmul_flops(n_tracks: int) -> int:
    """Analytic matmul FLOPs per FLOP-bound train step (full-graph
    strategy: every layer convolves the WHOLE catalog, N*T Q-rows +
    N W-rows; backward ~2x forward on the same matmuls)."""
    total = 0
    d_in = FEAT_DIM
    for _ in range(FB_LAYERS):
        total += 2 * n_tracks * T * d_in * FB_HIDDEN          # Q
        total += 2 * n_tracks * (d_in + FB_HIDDEN) * FB_OUT   # W
        d_in = FB_OUT
    total += 2 * (3 * FB_BATCH) * FB_OUT * FB_OUT * 2          # G1+G2 head
    return 3 * total                                           # fwd + bwd


def flopbound_activation_bytes(n_tracks: int = N_TRACKS) -> int:
    """HBM traffic of the FB step's saved intermediates: each layer's Q
    activation [N*T, hidden] and W concat/output are written by the
    forward and re-read by the backward (2 passes) -- bench.py's model of
    the save-and-reload traffic a training step adds."""
    rows = n_tracks * T
    total = 0
    d_in = FEAT_DIM
    for _ in range(FB_LAYERS):
        total += 2 * rows * FB_HIDDEN * 4              # Q activation
        total += 2 * n_tracks * (d_in + FB_HIDDEN) * 4  # W concat input
        total += 2 * n_tracks * FB_OUT * 4             # layer output h
        d_in = FB_OUT
    return total


def flopbound_products(n_tracks: int = N_TRACKS) -> dict:
    """The FLOPs of the dense products one FLOP-bound step's function
    needs, whatever computes them:

    * ``"q_forward"``: each layer's Q projection, every table row once
      (2 N Din H: the full-graph layer projects the table and then
      gathers, where the script counts N*T projected rows);
    * ``"q_backward"``: dWq, and dh where the table is an activation
      (layers after the first), each 2 N Din H;
    * ``"w"``: the W half (2 N (Din + H) Out) and its backward (dWw, the
      aggregate's gradient 2 N H Out, the self rows' 2 N Din Out after
      the first layer);
    * ``"head"``: G1 and G2 on the 3B rows and their backward (6
      products of 2 (3B) Out Out)."""
    n, h, o = n_tracks, FB_HIDDEN, FB_OUT
    out = {"q_forward": 0, "q_backward": 0, "w": 0, "head": 0}
    d_in = FEAT_DIM
    for layer in range(FB_LAYERS):
        q = 2 * n * d_in * h
        out["q_forward"] += q
        out["q_backward"] += (2 if layer else 1) * q
        out["w"] += 2 * (2 * n * (d_in + h) * o) + 2 * n * h * o
        if layer:
            out["w"] += 2 * n * d_in * o
        d_in = FB_OUT
    out["head"] = 6 * 2 * (3 * FB_BATCH) * o * o
    return out


def flopbound_bound_ms(dtype: str = "float32",
                       n_tracks: int = N_TRACKS) -> float:
    """The least time the card could take for one FLOP-bound step: its
    products (``flopbound_products``) at ``F32_PRODUCT_FLOPS``, the
    forward Q projections of the 16-bit table at ``H100_BF16_FLOPS`` in
    the bf16 step.  The bytes the step must move (the features, the
    neighbor columns, the parameters and their Adam moments: ~0.05 ms
    at HBM's rate) never bind at this shape."""
    p = flopbound_products(n_tracks)
    q_rate = (H100_BF16_FLOPS if dtype == "bfloat16"
              else F32_PRODUCT_FLOPS)
    return (p["q_forward"] / q_rate
            + (p["q_backward"] + p["w"] + p["head"]) / F32_PRODUCT_FLOPS
            ) * 1e3


def headline_config() -> RunConfig:
    """``bench.py``'s overrides of the headline step."""
    return config_with_overrides(RunConfig(run_name="bench"), {
        "model.in_dim": FEAT_DIM, "model.hidden_dim": HIDDEN,
        "model.out_dim": OUT, "model.n_layers": N_LAYERS, "model.T": T,
        "train.batch_size": BATCH,
    })


def flopbound_config(dtype: str = "float32") -> RunConfig:
    """``bench.py``'s overrides of the FLOP-bound step."""
    return config_with_overrides(RunConfig(run_name=f"bench_fb_{dtype}"), {
        "model.in_dim": FEAT_DIM, "model.hidden_dim": FB_HIDDEN,
        "model.out_dim": FB_OUT, "model.n_layers": FB_LAYERS, "model.T": T,
        "train.batch_size": FB_BATCH, "train.fullgraph_forward": "on",
        "train.dtype": dtype,
    })


def chunk_timer(cfg: RunConfig, problem, dev, key: int):
    """``run_chunk(n_chunk, i)``: the wall of ``n_chunk`` steps of the
    trainer's chunk from a seed-0 init, on batches drawn from a generator
    seeded from (``key``, i), ending when the metrics reach the host."""
    features, nb_w, nb_n, positives = problem
    n = features.shape[0]
    mcfg = cfg.model
    tables = TrainTables.build(features, nb_w, nb_n, mcfg.T, dev,
                               cfg.train.dtype)
    pos = torch.as_tensor(positives, device=dev)
    params = seeded_params(dev, FEAT_DIM, mcfg.n_layers, mcfg.hidden_dim,
                           mcfg.out_dim)
    opt = make_optimizer(params, cfg.train)
    fullgraph = use_fullgraph(cfg.train, mcfg, n)

    def run_chunk(n_chunk: int, i: int) -> float:
        t0 = time.perf_counter()
        metrics = train_chunk(params, opt, tables, pos,
                              block_generator(key, i, dev), cfg.train, mcfg,
                              n, n_chunk, fullgraph)
        metrics.cpu()
        return time.perf_counter() - t0

    return run_chunk


def kernels_built() -> bool:
    return all(cuda_build.library_path(n).is_file()
               for n in cuda_build.SOURCES)


def measure_step(problem, dev, small: int = CHUNK_SMALL,
                 large: int = CHUNK_LARGE, reps: int = REPS):
    """(seconds a batch, warmup_s, kernel_build) of the headline step."""
    build = ("cached" if kernels_built() else "built"
             ) if dev.type == "cuda" else "none"
    t0 = time.perf_counter()
    run_chunk = chunk_timer(headline_config(), problem, dev, 1)
    run_chunk(small, 0)
    first_s = time.perf_counter() - t0
    run_chunk(large, 1)
    warmup_s = time.perf_counter() - t0
    log(f"kernel build + warmup: {warmup_s:.1f}s (first chunk "
        f"{first_s:.1f}s, kernels {build})")
    per_batch = chunk_difference(run_chunk, small, large, reps,
                                 lambda msg: log(f"  step {msg}"))
    log(f"{platform(dev)} per-batch: {per_batch * 1e3:.3f} ms "
        f"(epoch of 500 batches ~ {per_batch * 500:.2f}s)")
    return per_batch, warmup_s, build


def measure_flopbound(problem, dev, dtype: str = "float32",
                      small: int = FB_CHUNK_SMALL,
                      large: int = FB_CHUNK_LARGE, reps: int = REPS):
    """(seconds a batch, TFLOP/s of ``flopbound_matmul_flops``) of the
    FLOP-bound step in ``dtype``."""
    t0 = time.perf_counter()
    run_chunk = chunk_timer(flopbound_config(dtype), problem, dev, 2)
    run_chunk(small, 0)
    run_chunk(large, 1)
    log(f"flopbound {dtype} warmup: {time.perf_counter() - t0:.1f}s")
    per_batch = chunk_difference(run_chunk, small, large, reps,
                                 lambda msg: log(f"  fb {dtype} {msg}"))
    tflops = flopbound_matmul_flops(problem[0].shape[0]) / per_batch / 1e12
    bound_ms = flopbound_bound_ms(dtype, problem[0].shape[0])
    log(f"flopbound {dtype} per-batch: {per_batch * 1e3:.3f} ms = "
        f"{tflops:.1f} TFLOP/s ({100 * bound_ms / (per_batch * 1e3):.0f}% "
        f"of the card's bound, {bound_ms:.3f} ms)")
    return per_batch, tflops


def device_wall(dev):
    """``wall(f)``: seconds of ``f()`` on ``dev`` (CUDA events around it
    on the card, the host's clock on the CPU).  On the card a sleep
    kernel (~10 ms) holds the stream while the events and ``f``'s work
    are queued, so the events time the device's work and not the host's
    issuing of it: a probe's wall is well under a millisecond, and a
    host stall inside it could turn a rep difference negative."""
    def wall(f) -> float:
        if dev.type != "cuda":
            t0 = time.perf_counter()
            float(f())
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return wall


def rep_difference(wall, run, small: int, large: int, reps: int) -> float:
    """Seconds a rep of ``run(n_reps)``: the median of (large - small) /
    (large - small) after one call of each, measured again where it is
    not positive (``fullgraph_bench.positive_median``; the root
    ``bench.py`` returns it as it is)."""
    wall(lambda: run(small))
    wall(lambda: run(large))

    def measure():
        walls = [(wall(lambda: run(large)), wall(lambda: run(small)))
                 for _ in range(reps)]
        return [(a - b) / (large - small) for a, b in walls], walls
    return positive_median(measure, f"reps of {small} and {large}")


def measure_gather_rates(dev, n_tracks: int = N_TRACKS,
                         widths=(256, 512, 1024), n_idx: int | None = None,
                         reps_small: int = 4, reps_large: int = 20,
                         reps: int = REPS):
    """({width: rows/s} of f32 tables, rows/s of a bf16 512-wide table):
    ``agg.gather_read_probe`` gathers ``n_idx`` (N*T) random rows a rep
    and reduces them without writing them back, timed by the rep
    difference.  rate(512) / rate(1024) ~ 1 says the gather is bound by
    rows, ~2 by bytes."""
    n_idx = n_tracks * T if n_idx is None else n_idx
    rng = np.random.default_rng(7)
    idx = torch.as_tensor(rng.integers(0, n_tracks, n_idx).astype(np.int32),
                          device=dev)
    wall = device_wall(dev)

    def measure(h, d, bytes_per_el):
        per_rep = rep_difference(
            wall, lambda r: agg.gather_read_probe(h, idx, r), reps_small,
            reps_large, reps)
        rate = n_idx / per_rep
        log(f"gather rate d={d} ({bytes_per_el}B/el): "
            f"{rate / 1e6:.1f}M rows/s "
            f"({rate * d * bytes_per_el / 1e9:.0f} GB/s)")
        return rate

    rates = {}
    rng2 = np.random.default_rng(8)
    for d in widths:
        h = torch.as_tensor(
            rng2.normal(size=(n_tracks, d)).astype(np.float32), device=dev)
        rates[d] = measure(h, d, 4)
    h16 = torch.as_tensor(rng2.normal(size=(n_tracks, 512)).astype(
        np.float32), device=dev).to(torch.bfloat16)
    rate_bf16 = measure(h16, 512, 2)
    return rates, rate_bf16


def measure_stream_bw(dev, reps_small: int = 20, reps_large: int = 200,
                      reps: int = REPS) -> float:
    """Streaming read rate (bytes/s): ``agg.l2_read_probe`` reads a
    STREAM_MIB MiB f32 array (256 MiB exceeds the card's L2, so every
    pass streams from device memory) once a pass, nothing written back,
    timed by the pass difference.  On the CPU a sum of each pass stands
    in for the probe."""
    x = torch.ones(STREAM_MIB * 1024 * 1024 // 4, dtype=torch.float32,
                   device=dev)
    read = (agg.l2_read_probe if dev.type == "cuda"
            else lambda src, r: sum(src.sum() for _ in range(r)))
    per_pass = rep_difference(device_wall(dev), lambda r: read(x, r),
                              reps_small, reps_large, reps)
    bw = x.numel() * 4 / per_pass
    log(f"stream read bandwidth: {bw / 1e9:.0f} GB/s")
    return bw


def roofline_predict(gather_rates: dict, stream_bw: float, compute_s: float,
                     n_tracks: int = N_TRACKS
                     ) -> tuple[float, float, float]:
    """(gather, matmul, activation) predicted seconds per FLOP-bound
    train step, from the measured gather row rates, the step's compute
    time ``compute_s`` (the card's bound, ``flopbound_bound_ms``, in
    place of the script's TPU ceiling), and the measured streaming
    bandwidth.  Layer input widths at the FB shape: FEAT_DIM then FB_OUT
    (the fullgraph forward gathers N*T rows of the running h per
    layer)."""
    dims = [FEAT_DIM] + [FB_OUT] * (FB_LAYERS - 1)
    rows = n_tracks * T

    def rate(d):
        if d in gather_rates:
            return gather_rates[d]
        # interpolate in rows/s between measured widths
        ws = sorted(gather_rates)
        lo = max([w for w in ws if w <= d], default=ws[0])
        hi = min([w for w in ws if w >= d], default=ws[-1])
        if lo == hi:
            return gather_rates[lo]
        f = (d - lo) / (hi - lo)
        return gather_rates[lo] * (1 - f) + gather_rates[hi] * f

    gather_s = GATHER_PASSES * sum(rows / rate(d) for d in dims)
    act_s = flopbound_activation_bytes(n_tracks) / stream_bw
    return gather_s, compute_s, act_s


def measure_torch_baseline(features, nb_w, nb_n, positives) -> float:
    """Reference-equivalent per-batch time: torch CPU, 3 forwards + loss +
    backward + Adam, same math as pinsage_model.py:189-265 (independent
    re-implementation; weights random)."""
    torch.manual_seed(0)
    f = torch.from_numpy(features)
    w_all = torch.from_numpy(nb_w[:, :T].copy())
    n_all = torch.from_numpy(nb_n[:, :T].astype(np.int64))
    pos = torch.from_numpy(positives.astype(np.int64))
    n_tracks = features.shape[0]

    dims_in = [FEAT_DIM, OUT]
    layers = []
    params = []
    for l in range(N_LAYERS):
        Q = torch.nn.Linear(dims_in[l], HIDDEN)
        W = torch.nn.Linear(dims_in[l] + HIDDEN, OUT)
        layers.append((Q, W))
        params += list(Q.parameters()) + list(W.parameters())
    G1 = torch.nn.Linear(OUT, OUT)
    G2 = torch.nn.Linear(OUT, OUT, bias=False)
    params += list(G1.parameters()) + list(G2.parameters())
    opt = torch.optim.Adam(params, lr=1e-4)
    lrelu = torch.nn.functional.leaky_relu

    def forward(nodeset):
        frontiers = [nodeset]
        nbs = []
        for _ in range(N_LAYERS):
            fr = frontiers[-1]
            nbs.append((w_all[fr], n_all[fr]))
            frontiers.append(torch.cat([fr, n_all[fr].reshape(-1)]))
        h = f[frontiers[-1]]
        for l in range(N_LAYERS - 1, -1, -1):
            m = frontiers[l].shape[0]
            Q, W = layers[N_LAYERS - 1 - l]
            nb_wt, _ = nbs[l]
            h_nb = h[m:].reshape(m, T, h.shape[1])
            q = lrelu(Q(h_nb))
            agg = (nb_wt[:, :, None] * q).sum(1) / nb_wt.sum(1, keepdim=True)
            h = lrelu(W(torch.cat([h[:m], agg], dim=1)))
            h = h / h.norm(dim=1, keepdim=True)
        return G2(lrelu(G1(h)))

    def step(i):
        rng = np.random.default_rng(i)
        rows = rng.integers(0, pos.shape[0], BATCH)
        batch = pos[rows]
        neg = torch.from_numpy(
            rng.integers(0, n_tracks, BATCH).astype(np.int64))
        hq = forward(batch[:, 0])
        hp = forward(batch[:, 1])
        hn = forward(neg)
        nrm = torch.nn.functional.normalize
        hq, hp, hn = nrm(hq, dim=1), nrm(hp, dim=1), nrm(hn, dim=1)
        loss = torch.clamp((hq * hn).sum(1) - (hq * hp).sum(1) + 1e-5,
                           min=0).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()

    step(0)  # warmup
    n_steps = 20
    t0 = time.time()
    for i in range(1, n_steps + 1):
        step(i)
    per_batch = (time.time() - t0) / n_steps
    log(f"torch-cpu per-batch: {per_batch * 1e3:.2f} ms")
    return per_batch


def baseline_config(n_tracks: int) -> dict:
    return {"batch": BATCH, "n_layers": N_LAYERS, "T": T, "hidden": HIDDEN,
            "out": OUT, "feat_dim": FEAT_DIM, "n_tracks": n_tracks}


def cached_baseline(n_tracks: int, path: str = BASELINE_PATH):
    """``BENCH_BASELINE.json``'s torch-CPU seconds a batch, or None where
    the file is missing or was measured for another configuration.  The
    file is only read."""
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        d = json.load(fh)
    if d.get("config") != baseline_config(n_tracks):
        log("cached baseline is for a DIFFERENT bench config -- ignoring it")
        return None
    return d.get("torch_cpu_s_per_batch")


def card_line(dev) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None on the
    CPU."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--tracks", type=int, default=N_TRACKS)
    ap.add_argument("--chunk-small", type=int, default=CHUNK_SMALL)
    ap.add_argument("--chunk-large", type=int, default=CHUNK_LARGE)
    ap.add_argument("--fb-chunk-small", type=int, default=FB_CHUNK_SMALL)
    ap.add_argument("--fb-chunk-large", type=int, default=FB_CHUNK_LARGE)
    ap.add_argument("--reps", type=int, default=REPS,
                    help="repetitions of each chunk difference (the "
                         "probes always take REPS)")
    ap.add_argument("--skip-probes", action="store_true",
                    help="leave out the gather and stream probes and the "
                         "roofline")
    ap.add_argument("--fresh-baseline", action="store_true",
                    help="also measure the torch-CPU baseline on this host")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log(f"device: {platform(dev)}")
    n = args.tracks
    problem = build_problem(0, n)
    features, nb_w, nb_n, positives = problem
    eps = edges_per_step(BATCH, N_LAYERS, T)
    log(f"edges per step: {eps}")

    per_batch, warmup_s, build = measure_step(
        problem, dev, args.chunk_small, args.chunk_large, args.reps)
    fb = {}
    for dtype in ("float32", "bfloat16"):
        fb[dtype] = measure_flopbound(problem, dev, dtype,
                                      args.fb_chunk_small,
                                      args.fb_chunk_large, args.reps)
    # contiguous-neighbor control: the same f32 step with neighbor ids =
    # consecutive rows, so every gather is a near-stream
    nb_n_contig = ((np.arange(n, dtype=np.int64)[:, None]
                    + np.arange(nb_n.shape[1])[None, :])
                   % n).astype(np.int32)
    fb_c_per_batch, _ = measure_flopbound(
        (features, nb_w, nb_n_contig, positives), dev, "float32",
        args.fb_chunk_small, args.fb_chunk_large, args.reps)
    fb_per_batch = fb["float32"][0]
    log(f"flopbound contiguous-gather control: {fb_c_per_batch*1e3:.3f} "
        f"ms vs random {fb_per_batch*1e3:.3f} ms -> exposed gather "
        f"share {(1 - fb_c_per_batch/fb_per_batch)*100:.0f}%")

    cached = cached_baseline(n)
    out = {"metric": "train_edges_per_s_chip",
           "value": round(eps / per_batch, 1),
           "unit": "edges/s",
           "vs_baseline": (round(cached / per_batch, 3)
                           if cached is not None else None),
           "warmup_s": round(warmup_s, 1),
           "kernel_build": build,
           "warm_step_ms": round(per_batch * 1e3, 4),
           "edges_per_step": eps}
    for dtype, prefix in (("float32", "flopbound"),
                          ("bfloat16", "flopbound_bf16")):
        step_s, tflops = fb[dtype]
        bound_ms = flopbound_bound_ms(dtype, n)
        out.update({f"{prefix}_tflops": round(tflops, 2),
                    f"{prefix}_mfu_vs_ceiling": round(
                        bound_ms / (step_s * 1e3), 3),
                    f"{prefix}_bound_ms": round(bound_ms, 3),
                    f"{prefix}_step_ms": round(step_s * 1e3, 3)})
    out["flopbound_contig_step_ms"] = round(fb_c_per_batch * 1e3, 3)

    if not args.skip_probes:
        # the probes take REPS repetitions whatever --reps says, as
        # bench.py's do
        gather_rates, gather_rate_bf16_512 = measure_gather_rates(dev, n)
        stream_bw = measure_stream_bw(dev)
        gather_pred_s, matmul_pred_s, act_pred_s = roofline_predict(
            gather_rates, stream_bw, flopbound_bound_ms("float32", n) / 1e3,
            n)
        pred_s = gather_pred_s + matmul_pred_s + act_pred_s
        roofline_ratio = fb_per_batch / pred_s
        wide_ratio = gather_rates[512] / gather_rates[1024]
        bf16_gather_ratio = gather_rate_bf16_512 / gather_rates[512]
        log(f"roofline: predicted {1e3 * pred_s:.2f} ms (gather "
            f"{1e3 * gather_pred_s:.2f} + matmul {1e3 * matmul_pred_s:.2f} "
            f"+ activations {1e3 * act_pred_s:.2f}) vs measured "
            f"{1e3 * fb_per_batch:.2f} ms -> ratio {roofline_ratio:.3f}; "
            f"rate512/rate1024 = {wide_ratio:.2f} (~1 = row-bound, ~2 = "
            f"byte-bound); bf16 rows gather {bf16_gather_ratio:.2f}x f32 "
            f"at d=512")
        out.update({
            "flopbound_roofline_ratio": round(roofline_ratio, 3),
            "roofline_pred_ms": {
                "gather": round(gather_pred_s * 1e3, 3),
                "matmul": round(matmul_pred_s * 1e3, 3),
                "activations": round(act_pred_s * 1e3, 3)},
            "hbm_stream_gbps": round(stream_bw / 1e9, 1),
            "gather_mrows_per_s": {str(d): round(r / 1e6, 1)
                                   for d, r in gather_rates.items()},
            "gather_wide_row_ratio": round(wide_ratio, 3),
            "gather_bf16_row_ratio": round(bf16_gather_ratio, 3)})
    out["flopbound_config"] = (f"L{FB_LAYERS}-h{FB_HIDDEN}-o{FB_OUT}-"
                               f"B{FB_BATCH}-fullgraph")
    if args.fresh_baseline:
        here = measure_torch_baseline(features, nb_w, nb_n, positives)
        out["vs_baseline_this_host"] = round(here / per_batch, 3)
    out["platform"] = platform(dev)
    out["card"] = card_line(dev)
    return out


def main(argv=None) -> dict:
    out = run(parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
