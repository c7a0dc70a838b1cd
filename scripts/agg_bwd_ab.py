"""Time the aggregation's backward kernels (``csrc/agg_bwd.cu``) of one or
more checkouts of the port on one card, to compare kernel versions in one
run:

    python scripts/agg_bwd_ab.py [--ids PATH] TREE [TREE ...]

First the full graph's ids: ``chip_smoke.py``'s main dataset (100,000
tracks, 25,000 collections of 20, 200,000 positives, seed 0), co-listen
augmented, and its PPR sweep with K1 (``RunConfig.recommended()``), the
first T = 10 neighbor ids and weights of every track saved to PATH
(default ``build/agg_bwd_ab/ids.npz``; made once, kept).  Then each TREE
(the root of a checkout) is imported in a process of its own, which
builds that checkout's kernels into its own ``build/torch_kernels/``, and
prints one JSON line of ``ms`` a call (5 calls after 2, queued behind a
sleep kernel so the CUDA events time them back to back on the device,
the median of 3 such runs):

- the table form (``agg.agg_bwd_rows`` over ``agg.backward_csr``: the
  weights, hub and row kernels) at N = 100,000, T = 10, H = 512 with a K2
  residual and f32 weights, on the catalog's ids (``catalog``), on
  uniform ids (``uniform``) and on ids naming rows 100,000, 10,000, 3,000
  and 300 times at random places, the rest uniform (``hubs``,
  ``chip_smoke.py``'s ``HUB_RUNS``), in 0 and 3 bf16 passes (``_p3``),
  with the CSR's time (``csr_*``) and the MiB that one call of the
  table form allocates beyond its inputs at its peak (``mem_*``: S, the
  dbq partials and the scratch);
- the frontier train step's layer 0 (4,224 nodes x T = 10 naming each of
  42,240 rows once, H 512, K3's slope bits): the frontier form
  (``agg.agg_bwd_frontier``, ``front``) where TREE has it, and the table
  form over the CSR of the ``arange`` (``front_csr`` + ``front_table``).

Every kernel output of a TREE with the chunked order of sums (where
``agg.BWD_RUN`` is defined) is held bit for bit against its plain twin
on the card, and the run fails otherwise.  Run trees in turns (parent, change,
change, parent) and compare only within one run: cards and hosts
differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, H = 100_000, 10, 512
HUB_RUNS = (100_000, 10_000, 3000, 300)
FRONT_B = 4224
REPS, WARMUP, ROUNDS = 5, 2, 3


def make_ids(path: str) -> None:
    """The full graph's [N, T] neighbor ids and weights, saved to path."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from gcn_song_embeddings_tpu_torch.config import RunConfig
    from gcn_song_embeddings_tpu_torch.data.device import (
        DeviceGraph,
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.data.synth import (
        make_synthetic_dataset,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods,
    )

    ds = os.path.join(os.path.dirname(path), "dataset")
    make_synthetic_dataset(ds, n_tracks=N, n_collections=25_000,
                           tracks_per_collection=20, n_positives=200_000,
                           feature_dim=512, seed=0)
    cfg = RunConfig.recommended()
    graph = SongGraph(ds, features_file=os.path.join(ds, "features.npy"))
    train_pos, _ = graph.load_positives_split(
        os.path.join(ds, "positives.json"))
    dg, _ = apply_colisten_config(
        DeviceGraph.from_graph(graph, torch.device("cuda")), train_pos,
        cfg.walk, None)
    nb_w, nb_n = precompute_neighborhoods(dg, cfg.walk, None, seed=0)
    np.savez(path, ids=np.asarray(nb_n[:, :T], np.int32),
             wts=np.asarray(nb_w[:, :T], np.float32))


def measure(tree: str, ids_path: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from gcn_song_embeddings_tpu_torch.ops import agg

    dev = torch.device("cuda")

    def ms(fn) -> float:
        times = []
        for _ in range(ROUNDS):
            for _ in range(WARMUP):
                fn()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            a.record()
            for _ in range(REPS):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / REPS)
        return float(np.median(times))

    def peak_mib(fn) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    def held(got, want, what: str) -> None:
        (parts, _), (ref, _) = got, want
        if not all(torch.equal(g, r) for g, r in zip(parts, ref)):
            raise AssertionError(f"{tree}: {what} differs from its twin")

    def run_ids(runs, seed):
        rng = np.random.default_rng(seed)
        flat = rng.integers(len(runs), N, N * T)
        places = rng.permutation(N * T)
        at = 0
        for row, k in enumerate(runs):
            flat[places[at:at + k]] = row
            at += k
        return torch.as_tensor(flat.reshape(N, T).astype(np.int32),
                               device=dev)

    saved = np.load(ids_path)
    gen = torch.Generator(device=dev).manual_seed(3)
    dagg = torch.randn((N, H), device=dev, generator=gen)
    proj = torch.randn((H // agg.SLAB, N, agg.SLAB), device=dev,
                       generator=gen)
    id_sets = {
        "catalog": (torch.as_tensor(saved["ids"], device=dev),
                    torch.as_tensor(saved["wts"], device=dev)),
        "uniform": (run_ids((), 5), None),
        "hubs": (run_ids(HUB_RUNS, 5), None)}
    chunked = hasattr(agg, "BWD_RUN")
    out = {"tree": tree}
    for name, (ids, wts) in id_sets.items():
        if wts is None:
            wts = torch.rand((N, T), device=dev, generator=gen)
        csr = agg.backward_csr(ids, N)
        out[f"csr_{name}"] = ms(lambda: agg.backward_csr(ids, N))
        for passes in (None, 3):
            args = (*csr, wts, dagg, proj, passes)
            if chunked:   # a tree before the chunked order: its twin
                # sums a hub's 100,000 entries one by one
                held(agg.agg_bwd_rows(*args), agg.agg_bwd_rows_plain(*args),
                     f"the table form on {name} in {passes} passes")
            key = f"{name}{'_p3' if passes else ''}"
            out[key] = ms(lambda: agg.agg_bwd_rows(*args))
            out[f"mem_{key}"] = peak_mib(lambda: agg.agg_bwd_rows(*args))
        del csr
    wf = torch.rand((FRONT_B, T), device=dev, generator=gen)
    df = torch.randn((FRONT_B, H), device=dev, generator=gen)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1,
                         (FRONT_B * T, agg.slope_words(H)), device=dev,
                         dtype=torch.int64, generator=gen).to(torch.int32)
    ids = torch.arange(FRONT_B * T, dtype=torch.int32,
                       device=dev).reshape(FRONT_B, T)
    csr = agg.backward_csr(ids, FRONT_B * T)
    out["front_csr"] = ms(lambda: agg.backward_csr(ids, FRONT_B * T))
    out["front_table"] = ms(lambda: agg.agg_bwd_rows(*csr, wf, df, bits))
    if hasattr(agg, "agg_bwd_frontier"):
        for passes in (None, 3):
            args = (wf, df, bits, passes)
            held(agg.agg_bwd_frontier(*args),
                 agg.agg_bwd_rows_plain(*csr, *args),
                 f"the frontier form in {passes} passes")
            out[f"front{'_p3' if passes else ''}"] = ms(
                lambda: agg.agg_bwd_frontier(*args))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--ids", default=os.path.join(ROOT, "build", "agg_bwd_ab",
                                                  "ids.npz"))
    ap.add_argument("--measure", action="store_true",
                    help="time the one TREE given in this process")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.trees[0], args.ids)), flush=True)
        return 0
    if not os.path.exists(args.ids):
        os.makedirs(os.path.dirname(args.ids), exist_ok=True)
        make_ids(args.ids)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    failed = 0
    for tree in args.trees:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--measure", "--ids", args.ids, tree],
                            check=False).returncode
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
