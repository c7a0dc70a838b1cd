"""Time the aggregation's 16-bit-core forms of one or more checkouts of the
port on one card, to compare kernel versions in one run:

    python scripts/bf16x_ab.py [--no-epilogue] TREE [TREE ...]

Each TREE is the root of a checkout.  Its package is imported in a process
of its own, which builds that checkout's kernels into its own
``build/torch_kernels/``, and prints one JSON line: the card, ``ms`` a call
(20 calls after 3, queued behind a sleep kernel so the CUDA events time
them back to back on the device) of the bf16x forms (an f32 table in one or
three bf16 passes, ``GCN_TPU_MATMUL_PRECISION`` default / high) of K3 at
co1_T10_wide's two aggregations (4,224 nodes x T=10 over a 20,000 x 128
table and 384 x 10 over 42,240 x 256, H 1024) and at the 100k step's
layer 0 (4,224 x 10 of 100,000 x 512, H 512), of K2's projection of 20,000
rows at Din 128 and 256 (H 1024), and of the 16-bit table forms (bf16 and
f16): K3 at the Din 128 and 512 shapes, K2's projection of 20,000 rows at
Din 512 and 256 (H 1024, the FLOP-bound step's layers), and K2's whole
16-bit call (projection + gather-mean) at the FLOP-bound step's shapes
(20,000 nodes x T = 3 over the 20,000-row table at Din 512 and 256, H
1024, weights of the table's type) with its gather-mean alone and its
library call (one ``torch.einsum`` of the gathered 16-bit rows with the
16-bit Wq, as ``chip_smoke.py`` times it; ``_library`` keys); and
``digests``: sha1 prefixes of the outputs, equal across trees whose
kernels compute the same bits.  Ids are drawn at random over each table from fixed seeds.
``--no-epilogue`` times each TREE's copy built with ``AGG_TC_EPILOGUE`` 0
(under ``TREE/build/``): the 16-bit core without its epilogue, which then
writes nothing, so its digests differ; what the tiles cost without it.
Run trees in turns (parent, change, change, parent) and compare only
within one run: cards and hosts differ.  A change to the core's order of
sums (as the promotion of its partial sums) changes the digests by
design.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys

PACKAGE = "gcn_song_embeddings_tpu_torch"
# csrc/agg_tc.cuh's switch of the 16-bit core's epilogue
EPILOGUE_SWITCH = "AGG_TC_EPILOGUE"
K3_SHAPES = {  # name: (table rows, nodes, T, Din, H)
    "wide_deep": (20000, 4224, 10, 128, 1024),
    "wide_top": (42240, 384, 10, 256, 1024),
    "l0_100k": (100000, 4224, 10, 512, 512)}
K2_DINS = (128, 256)        # K2's bf16x projection of 20,000 rows, H 1024
K2_16_DINS = (512, 256)     # K2's 16-bit projection of 20,000 rows, H 1024
K2_FB = (20000, 3)          # the FLOP-bound step: nodes (= table rows), T
REPS, WARMUP = 20, 3


def without_epilogue(tree: str) -> str:
    """A copy of ``tree``'s package under ``tree/build/`` whose header
    sets ``AGG_TC_EPILOGUE`` to 0 before anything else; returns the
    copy's root."""
    root = os.path.join(tree, "build", "bf16x_ab_no_epilogue")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(tree, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, PACKAGE, "csrc", "agg_tc.cuh")
    with open(path) as f:
        src = f.read()
    if f"#ifndef {EPILOGUE_SWITCH}" not in src:
        raise ValueError(f"{path}: no {EPILOGUE_SWITCH} switch: this "
                         f"tree's core cannot drop its epilogue")
    with open(path, "w") as f:
        f.write(f"#define {EPILOGUE_SWITCH} 0\n" + src)
    return root


def measure(tree: str) -> dict:
    """The timings and digests of ``tree``'s kernels; run in a process
    whose ``sys.path`` starts with ``tree``."""
    import torch

    from gcn_song_embeddings_tpu_torch.ops import agg, cuda_build
    from gcn_song_embeddings_tpu_torch.utils import precision

    if not agg.__file__.startswith(os.path.join(tree, PACKAGE)):
        raise RuntimeError(f"{PACKAGE} came from {agg.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("bf16x_ab times kernels on a CUDA card")
    cuda_build.build(("agg", "dma_agg"))
    dev = torch.device("cuda")

    def ms(fn) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    def problem(n, m, t, din, h, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn((n, din), device=dev, generator=g),
                torch.randint(0, n, (m, t), device=dev, generator=g,
                              dtype=torch.int32),
                torch.rand((m, t), device=dev, generator=g),
                torch.randn((h, din), device=dev, generator=g) * 0.05,
                torch.full((h,), 0.3, device=dev))

    def digest(x: torch.Tensor) -> str:
        return hashlib.sha1(x.cpu().numpy().tobytes()).hexdigest()[:12]

    value = {1: "default", 3: "high"}
    times, digests = {}, {}
    with torch.inference_mode():
        for name, (n, m, t, din, h) in K3_SHAPES.items():
            args = problem(n, m, t, din, h, seed=1)
            for passes in (1, 3):
                with precision.override(value[passes]):
                    def run():
                        return agg.conv_aggregate(*args, mode="dma")
                    times[f"k3_bf16x{passes}_{name}"] = ms(run)
                    digests[f"k3_bf16x{passes}_{name}"] = digest(run())
            if din != 256:
                tab, ids, w, wq, bq = args
                for dtype, form in ((torch.bfloat16, "bf16"),
                                    (torch.float16, "f16")):
                    tab16, wq16 = tab.to(dtype), wq.to(dtype)

                    def run16():
                        return agg.conv_aggregate(tab16, ids, w, wq16, bq,
                                                  mode="dma")
                    times[f"k3_{form}_{name}"] = ms(run16)
                    digests[f"k3_{form}_{name}"] = digest(run16())
                    del tab16
            del args
        for din in K2_DINS:
            tab, _, _, wq, bq = problem(20000, 1, 1, din, 1024, seed=2)
            for passes in (1, 3):
                hi, lo = agg.tile_wq_bf16x(wq, passes)

                def project():
                    return agg.project_table_bf16x(tab, hi, lo, bq, passes)
                times[f"k2_bf16x{passes}_project_{din}"] = ms(project)
                digests[f"k2_bf16x{passes}_project_{din}"] = digest(project())
        for din in K2_16_DINS:
            tab, _, _, wq, bq = problem(20000, 1, 1, din, 1024, seed=3)
            for dtype, form in ((torch.bfloat16, "bf16"),
                                (torch.float16, "f16")):
                tab16, tiles = tab.to(dtype), agg.tile_wq16(wq.to(dtype))

                def project16():
                    return agg.project_table16(tab16, tiles, bq)
                times[f"k2_{form}_project_{din}"] = ms(project16)
                digests[f"k2_{form}_project_{din}"] = digest(project16())
        n, t = K2_FB
        for din in K2_16_DINS:
            tab, ids, w, wq, bq = problem(n, n, t, din, 1024, seed=4)
            for dtype, form in ((torch.bfloat16, "bf16"),
                                (torch.float16, "f16")):
                tab16, wq16, w16 = tab.to(dtype), wq.to(dtype), w.to(dtype)
                key = f"k2_{form}_fb_{din}"

                def whole():
                    return agg.conv_aggregate(tab16, ids, w16, wq16, bq,
                                              mode="stream")
                times[key] = ms(whole)
                digests[key] = digest(whole())
                times[f"{key}_library"] = ms(lambda: torch.einsum(
                    "btd,hd->bth", tab16[ids.long()], wq16))
                proj = agg.project_table16(tab16, agg.tile_wq16(wq16), bq)
                out = torch.empty((n, 1024), device=dev)

                def gather():
                    return agg.gather_mean(proj, ids, w16, out)
                times[f"{key}_gather_mean"] = ms(gather)
                digests[f"{key}_gather_mean"] = digest(gather())
                del tab16, proj
    return {"card": torch.cuda.get_device_name(0), "ms": times,
            "digests": digests}


# the child process: argv[1] the tree to import, argv[2] this file
CHILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
         "import importlib.util as u; "
         "spec = u.spec_from_file_location('bf16x_ab', sys.argv[2]); "
         "m = u.module_from_spec(spec); spec.loader.exec_module(m); "
         "print(json.dumps(m.measure(sys.argv[1])))")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in turn")
    ap.add_argument("--no-epilogue", action="store_true",
                    help="time each tree's copy without the 16-bit core's "
                         "epilogue")
    args = ap.parse_args(argv)
    for tree in args.trees:
        tree = os.path.abspath(tree)
        root = without_epilogue(tree) if args.no_epilogue else tree
        out = subprocess.run(
            [sys.executable, "-c", CHILD, root, os.path.abspath(__file__)],
            cwd=root, check=True, stdout=subprocess.PIPE, text=True)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "no_epilogue": args.no_epilogue,
                          **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
