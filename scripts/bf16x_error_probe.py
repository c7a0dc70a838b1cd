"""How far the 16-bit core's forms of K3 and of K2's projection err against
float64, by Din, node count and seed, on one card:

    python scripts/bf16x_error_probe.py [--seeds 5] [--hdim 1024]
        [--kernels K3,K2] [--forms bf16x1,bf16x3,bf16,f16]
        [--dins 128,...] [--nodes 20,...]

For each kernel (K3, ``conv_aggregate(mode="dma")``; K2,
``mode="stream"``: the projection of every table row, then the f32
gather), each form -- ``bf16x1`` and ``bf16x3`` (an f32 table in one or
three bf16 passes, ``GCN_TPU_MATMUL_PRECISION`` default / high), ``bf16``
and ``f16`` (the table and Wq cast to that type: the core's own 16-bit
staging) -- each Din of ``DINS`` and each node count of ``NODES`` (T = 10
ids a node over a 20,000-row table; K3 reads those rows, K2 projects all
of them), and each seed, the kernel's output and its plain version's
(``ops.agg.conv_aggregate_plain``, f32 sums of the same rounded operands)
are compared with float64 of the same rounded function.  One JSON line a
(kernel, form, Din, nodes) on stdout: over the seeds, the max and RMS
errors of both, the ratio of the maxima (what
``tests/test_torch_bf16x_gpu.py`` bounds by 4x a pass), the ratio of the
RMS errors, and the mean signed error of both (a bias shows a summation
that truncates rather than rounds).  The probe measures the package of
the checkout it lies in: run another checkout's copy of it to measure
that one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DINS = (128, 256, 512, 704, 1024)
NODES = (20, 60, 600, 4224)
T, TABLE_ROWS = 10, 20000
FORMS = {"bf16x1": 1, "bf16x3": 3, "bf16": None, "f16": None}
KERNELS = {"K3": "dma", "K2": "stream"}


def problem(torch, dev, nodes, din, hdim, seed):
    """A seeded f32 table, ids over all of it, weights, Wq and bq."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((TABLE_ROWS, din), device=dev, generator=g),
            torch.randint(0, TABLE_ROWS, (nodes, T), device=dev,
                          generator=g, dtype=torch.int32),
            torch.rand((nodes, T), device=dev, generator=g),
            torch.randn((hdim, din), device=dev, generator=g) * 0.05,
            torch.full((hdim,), 0.3, device=dev))


def errors(torch, agg, precision, form, args, mode="dma"):
    """(kernel - float64, plain - float64) of one problem, float64."""
    passes = FORMS[form]
    tab, ids, w, wq, bq = args
    if passes is None:
        dtype = torch.bfloat16 if form == "bf16" else torch.float16
        tab, wq = tab.to(dtype), wq.to(dtype)
        got = agg.conv_aggregate(tab, ids, w, wq, bq, mode=mode)
        plain = agg.conv_aggregate_plain(tab, ids, w, wq, bq)
        ref = agg.conv_aggregate_plain(tab.double(), ids, w.double(),
                                       wq.double(), bq.double())
    else:
        with precision.override({1: "default", 3: "high"}[passes]):
            got = agg.conv_aggregate(tab, ids, w, wq, bq, mode=mode)
        plain = agg.conv_aggregate_plain(tab, ids, w, wq, bq, passes)
        ref = agg.conv_aggregate_plain(tab.double(), ids, w.double(),
                                       wq.double(), bq.double(), passes)
    return got.double() - ref, plain.double() - ref


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--hdim", type=int, default=1024)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--dins", type=_ints, default=DINS)
    ap.add_argument("--nodes", type=_ints, default=NODES)
    args = ap.parse_args(argv)
    for flag, names, known in (("--kernels", args.kernels, KERNELS),
                               ("--forms", args.forms, FORMS)):
        unknown = sorted(set(names.split(",")) - set(known))
        if unknown:
            ap.error(f"{flag}: unknown {', '.join(unknown)} (of "
                     f"{', '.join(known)})")

    import torch

    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.utils import precision

    if not torch.cuda.is_available():
        print("bf16x_error_probe measures the kernels on a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with torch.inference_mode():
        for kernel in args.kernels.split(","):
            for form in args.forms.split(","):
                for din in args.dins:
                    for nodes in args.nodes:
                        rows = []
                        for seed in range(args.seeds):
                            e, p = errors(torch, agg, precision, form,
                                          problem(torch, dev, nodes, din,
                                                  args.hdim, seed),
                                          KERNELS[kernel])
                            rows.append([float(x) for x in (
                                e.abs().max(), p.abs().max(),
                                e.square().mean().sqrt(),
                                p.square().mean().sqrt(), e.mean(),
                                p.mean())])
                        cols = list(zip(*rows))
                        print(json.dumps({
                            "kernel": kernel, "form": form, "din": din,
                            "nodes": nodes, "hdim": args.hdim,
                            "seeds": args.seeds,
                            "max_err": cols[0], "plain_max_err": cols[1],
                            "max_ratio": [a / b for a, b in zip(cols[0],
                                                                cols[1])],
                            "rms_ratio": [a / b for a, b in zip(cols[2],
                                                                cols[3])],
                            "mean_err": cols[4],
                            "plain_mean_err": cols[5]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
