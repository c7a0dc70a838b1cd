"""Full baseline roster on the HARD benchmark.

The port's counterpart of ``scripts/hard_roster.py``, without JAX.  On
``make_hard_dataset`` (20,000 tracks, power-law playlists, features that
reveal only the genre group) it trains five PinSage runs through the
port's ``cli train`` and evaluates the complete model roster through its
``cli eval`` (every row of the JAX CLI at K=1000, ``--pinsage-runs`` for
the five runs and ``--hybrid-runs`` for the widest co-listen run): the
accuracy and beyond-accuracy tables::

    synth (hard) -> 5 x cli train -> cli eval (full roster)

Expected ordering on this data: graph models (PinSage, PageRank, CF,
node2vec) > content (Features) > Random.  A run whose ``emb.npy`` exists
is reused; copies of co-listen edges other than 1 get a ``_x<N>``
run-name suffix.  The kNN caches go to ``<work-dir>/baselines``; the two
CSV tables are copied to ``--out-prefix`` (default
``<work-dir>/hard_roster``) + ``_accuracy.csv`` / ``_beyond.csv``::

    python -m gcn_song_embeddings_tpu_torch.hard_roster [--work-dir DIR] \\
        [--epochs 10] [--colisten-copies 1] [--device cpu]

Runs on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.data.synth import ensure_hard_dataset
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

# (run name, its `--set` overrides after the base ones); `{co}` is the
# co-listen copies and `{suffix}` the run-name suffix of copies other than 1
RUNS = (
    ("pinsage_hard", ()),
    ("pinsage_hard_hn", ("train.hard_negatives=true",)),
    # the hard-grid winner's schedule (results/grid_search_hard.json: 30
    # epochs, margin 1e-5, lr 1e-3, easy negatives, 2 layers)
    ("pinsage_hard_tuned", ("train.epochs=30", "train.margin=1e-05")),
    # tuned schedule + co-listen edges + T=10: the walks see the
    # train-positive co-occurrence signal the CF baselines factorize
    ("pinsage_hard_co{suffix}",
     ("train.epochs=30", "train.margin=1e-05", "model.T=10",
      "walk.colisten_copies={co}")),
    # wider variant (hidden 1024 / out 512)
    ("pinsage_hard_co512{suffix}",
     ("train.epochs=30", "train.margin=1e-05", "model.T=10",
      "model.hidden_dim=1024", "model.out_dim=512",
      "walk.colisten_copies={co}")),
)
HYBRID_RUN = "pinsage_hard_co512{suffix}"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "hard_roster"))
    ap.add_argument("--tracks", type=int, default=20_000)
    ap.add_argument("--collections", type=int, default=4_000)
    ap.add_argument("--positives", type=int, default=60_000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--colisten-copies", type=int, default=1)
    ap.add_argument("--out-prefix", default=None,
                    help="prefix of the two CSV copies (default: "
                         "<work-dir>/hard_roster)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def co_suffix(copies: int) -> str:
    """The run-name suffix of ``copies`` co-listen copies: none for 1, so
    variants never reuse a differently-configured run's checkpoint."""
    return "" if copies == 1 else f"_x{copies}"


def base_overrides(epochs: int) -> list[str]:
    """The ``--set`` flags every run starts from."""
    out = []
    for kv in (f"train.epochs={epochs}", "train.lr=0.001",
               "train.margin=0.1", "walk.batch_walkers=8192"):
        out += ["--set", kv]
    return out


def run_list(copies: int) -> list[tuple[str, list[str]]]:
    """``RUNS`` for ``copies``: [(run name, its extra ``--set`` flags)]."""
    suffix = co_suffix(copies)
    out = []
    for name, sets in RUNS:
        extra = []
        for kv in sets:
            extra += ["--set", kv.format(co=copies)]
        out.append((name.format(suffix=suffix), extra))
    return out


def eval_argv(ds: str, runs: str, eval_dir: str, run_names: list[str],
              hybrid: list[str], device: str) -> list[str]:
    """``cli eval`` of every row at the CLI's default K=1000."""
    return (["eval", "--dataset", ds, "--run-dir", runs,
             "--eval-dir", eval_dir, "--pinsage-runs", *run_names,
             "--hybrid-runs", *hybrid, "--device", device])


def main(argv=None) -> dict:
    """Train, evaluate, copy the tables; returns {table: copied path}."""
    args = parse_args(argv)
    if args.colisten_copies < 1:
        raise SystemExit("--colisten-copies must be >= 1: the *_co roster "
                         "rows are defined as co-listen-augmented runs")
    device = str(resolve_device(args.device))

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    work = args.work_dir
    ds = os.path.join(work, "ds")
    runs = os.path.join(work, "runs")
    os.makedirs(work, exist_ok=True)
    ensure_hard_dataset(ds, n_tracks=args.tracks,
                        n_collections=args.collections,
                        n_positives=args.positives, seed=0, log=log)

    base = base_overrides(args.epochs)
    planned = run_list(args.colisten_copies)
    for run_name, extra in planned:
        if os.path.isfile(os.path.join(runs, run_name, "emb.npy")):
            log(f"reusing trained run {run_name}")
            continue
        log(f"training {run_name} ...")
        cli.main(["train", "--dataset", ds, "--run-dir", runs,
                  "--run-name", run_name, "--device", device]
                 + base + extra)

    eval_dir = os.path.join(work, "baselines")
    log("evaluating full roster ...")
    cli.main(eval_argv(ds, runs, eval_dir, [r for r, _ in planned],
                       [HYBRID_RUN.format(
                           suffix=co_suffix(args.colisten_copies))],
                       device))

    prefix = args.out_prefix or os.path.join(work, "hard_roster")
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    copied = {}
    for src, table in (("results_accuracy.csv", "accuracy"),
                       ("results_beyond.csv", "beyond")):
        dst = f"{prefix}_{table}.csv"
        shutil.copy(os.path.join(eval_dir, src), dst)
        log(f"copied {src} -> {dst}")
        copied[table] = dst
    return copied


if __name__ == "__main__":
    main()
