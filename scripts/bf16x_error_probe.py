"""How far K3's 16-bit-operand forms err against float64, by Din, node
count and seed, on one card:

    python scripts/bf16x_error_probe.py [--seeds 5] [--hdim 1024]

For each form -- ``bf16x1`` and ``bf16x3`` (an f32 table in one or three
bf16 passes, ``GCN_TPU_MATMUL_PRECISION`` default / high) and ``bf16``
(the table and Wq cast to bf16: the 16-bit core's own staging) -- each
Din of ``DINS`` and each node count of ``NODES`` (T = 10 ids a node over
a 20,000-row table), and each seed, the kernel's output and its plain
version's (``ops.agg.conv_aggregate_plain``, f32 sums of the same
rounded operands) are compared with float64 of the same rounded function.
One JSON line a (form, Din, nodes) on stdout: over the seeds, the max
and RMS errors of both, the ratio of the maxima (what
``tests/test_torch_bf16x_gpu.py`` bounds by 4x a pass), the ratio of the
RMS errors, and the mean signed error of both (a bias shows a summation
that truncates rather than rounds).
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
FORMS = {"bf16x1": 1, "bf16x3": 3, "bf16": None}


def problem(torch, dev, nodes, din, hdim, seed):
    """A seeded f32 table, ids over all of it, weights, Wq and bq."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((TABLE_ROWS, din), device=dev, generator=g),
            torch.randint(0, TABLE_ROWS, (nodes, T), device=dev,
                          generator=g, dtype=torch.int32),
            torch.rand((nodes, T), device=dev, generator=g),
            torch.randn((hdim, din), device=dev, generator=g) * 0.05,
            torch.full((hdim,), 0.3, device=dev))


def errors(torch, agg, precision, form, args):
    """(kernel - float64, plain - float64) of one problem, float64."""
    passes = FORMS[form]
    tab, ids, w, wq, bq = args
    if passes is None:
        tab, wq = tab.bfloat16(), wq.bfloat16()
        got = agg.conv_aggregate(tab, ids, w, wq, bq, mode="dma")
        plain = agg.conv_aggregate_plain(tab, ids, w, wq, bq)
        ref = agg.conv_aggregate_plain(tab.double(), ids, w.double(),
                                       wq.double(), bq.double())
    else:
        with precision.override({1: "default", 3: "high"}[passes]):
            got = agg.conv_aggregate(tab, ids, w, wq, bq, mode="dma")
        plain = agg.conv_aggregate_plain(tab, ids, w, wq, bq, passes)
        ref = agg.conv_aggregate_plain(tab.double(), ids, w.double(),
                                       wq.double(), bq.double(), passes)
    return got.double() - ref, plain.double() - ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--hdim", type=int, default=1024)
    args = ap.parse_args(argv)

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
        for form in FORMS:
            for din in DINS:
                for nodes in NODES:
                    rows = []
                    for seed in range(args.seeds):
                        e, p = errors(torch, agg, precision, form, problem(
                            torch, dev, nodes, din, args.hdim, seed))
                        rows.append([float(x) for x in (
                            e.abs().max(), p.abs().max(),
                            e.square().mean().sqrt(),
                            p.square().mean().sqrt(), e.mean(), p.mean())])
                    cols = list(zip(*rows))
                    print(json.dumps({
                        "form": form, "din": din, "nodes": nodes,
                        "hdim": args.hdim, "seeds": args.seeds,
                        "max_err": cols[0], "plain_max_err": cols[1],
                        "max_ratio": [a / b for a, b in zip(cols[0],
                                                            cols[1])],
                        "rms_ratio": [a / b for a, b in zip(cols[2],
                                                            cols[3])],
                        "mean_err": cols[4], "plain_mean_err": cols[5]}),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
