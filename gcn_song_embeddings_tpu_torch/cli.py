"""Command-line entry point of the PyTorch/CUDA port.

Verbs:
  synth  -- write a synthetic dataset in the reference on-disk format
            (``--hard``: the benchmark where the graph must beat the
            features)
  train  -- PinSage training on one device (co-listen augmentation, PPR
            sweep, sampler, max-margin loss, Adam, chunked checkpoints
            with resume), then the embeddings of every track to
            <run-dir>/<run-name>/emb.npy
  embed  -- PPR neighborhood sweep + full-catalog PinSage embedding,
            params from a trainer checkpoint (either package's) under the
            ``config.json`` beside it, or a seeded init under
            ``RunConfig.recommended()``, written to one emb.npy
  eval   -- the baseline comparison: kNN lists of each model cached under
            --eval-dir, results_accuracy.csv and results_beyond.csv
  stats  -- dataset statistics

Features resolve as in the JAX CLI: ``features_<name>.npy``, then
``features.npy``, then the per-track directory ``features_<name>/``;
positives are ``--positives`` (which must exist) or the first of
``positives_lfm.json`` and ``positives.json``.

Usage:
  python -m gcn_song_embeddings_tpu_torch.cli synth --dataset DIR [--hard]
  python -m gcn_song_embeddings_tpu_torch.cli train --dataset DIR \
      [--run-name NAME] [--run-dir ./runs] [--config cfg.json] \
      [--set train.lr=0.001 ...] [--no-resume] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli embed --dataset DIR \
      --out emb.npy [--checkpoint state.npz] [--seed 0] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli eval --dataset DIR \
      [--pinsage-runs RUN ...] [--models NAME ...] [--k 1000] \
      [--eval-dir DIR] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli stats --dataset DIR

Serve the result with ``python -m gcn_song_embeddings_tpu_torch.serve``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# eval rows the JAX CLI has and the port does not have yet (ROADMAP.md,
# queue 1 item 4)
NOT_PORTED = ("JaccardFast", "Node2Vec", "TrackTrackCfALS", "TrackTrackCfBPR",
              "ColTrackCfALS", "ColTrackCfLMF", "GraphSAGE", "GAT", "GCN")


def cmd_synth(args) -> None:
    from gcn_song_embeddings_tpu_torch.data.synth import (
        make_hard_dataset,
        make_synthetic_dataset,
    )

    make = make_hard_dataset if args.hard else make_synthetic_dataset
    make(args.dataset, n_tracks=args.n_tracks,
         n_collections=args.n_collections, n_positives=args.n_positives,
         feature_dim=args.feature_dim, seed=args.seed)
    kind = "hard (graph>features) " if args.hard else "synthetic "
    print(f"{kind}dataset written to {args.dataset}")


def feature_sources(dataset: str, features: str) -> list[str]:
    """The feature files of ``dataset`` in the JAX CLI's order of
    preference: ``features_<name>.npy``, ``features.npy``, then the
    per-track directory ``features_<name>/``."""
    return [os.path.join(dataset, f"features_{features}.npy"),
            os.path.join(dataset, "features.npy"),
            os.path.join(dataset, f"features_{features}")]


def load_graph(dataset: str, features: str = "random",
               need_features: bool = True):
    """The dataset's ``SongGraph``, features resolved as the JAX CLI
    resolves them."""
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph

    if not need_features:
        return SongGraph(dataset)
    npy_name, npy, feat_dir = feature_sources(dataset, features)
    for path in (npy_name, npy):
        if os.path.isfile(path):
            return SongGraph(dataset, features_file=path)
    return SongGraph(dataset, features_dir=feat_dir)


def positives_path(dataset: str, positives: str | None = None) -> str:
    """An explicit ``positives`` file (which must exist: a typo must not
    fall back to other pairs), else the first of ``positives_lfm.json``
    and ``positives.json``."""
    if positives:
        path = os.path.join(dataset, positives)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"--positives {positives!r} not found "
                                    f"in {dataset}")
        return path
    for name in ("positives_lfm.json", "positives.json"):
        path = os.path.join(dataset, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no positives file found in {dataset}")


def run_config(run_name: str, config: str | None, overrides: list[str]):
    """``RunConfig()`` (or the ``config`` JSON file) named ``run_name``,
    with ``KEY=JSON`` overrides applied."""
    from gcn_song_embeddings_tpu_torch.config import (
        RunConfig,
        config_with_overrides,
    )

    cfg = RunConfig(run_name=run_name)
    if config:
        if not os.path.isfile(config):
            raise FileNotFoundError(f"--config {config!r} not found")
        with open(config) as f:
            cfg = RunConfig.from_json(f.read()).replace(run_name=run_name)
    values = {}
    for kv in overrides or []:
        key, _, value = kv.partition("=")
        values[key] = json.loads(value)
    return config_with_overrides(cfg, values)


def cmd_train(args) -> None:
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = run_config(args.run_name, args.config, args.set)
    graph = load_graph(args.dataset, args.features)
    if graph.features is None:
        raise SystemExit(f"no features found in {args.dataset}")
    train_pos, _ = graph.load_positives_split(
        positives_path(args.dataset, args.positives))
    trainer = PinSageTrainer(DeviceGraph.from_graph(graph, dev),
                             graph.n_items, graph.features, train_pos,
                             cfg=cfg, base_run_dir=args.run_dir,
                             nbhds_path=graph.nbhds_path, log=True,
                             load_save=not args.no_resume)
    trainer.train()
    print(f"embeddings -> {trainer.save_embeddings()}")


def checkpoint_config(checkpoint: str | None):
    """The ``config.json`` a trainer wrote beside ``checkpoint``, or
    ``RunConfig.recommended()`` where there is none."""
    from gcn_song_embeddings_tpu_torch.config import RunConfig

    if checkpoint:
        path = os.path.join(os.path.dirname(os.path.abspath(checkpoint)),
                            "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return RunConfig.from_json(f.read())
    return RunConfig.recommended()


def embed_dataset(dataset: str, checkpoint: str | None = None,
                  seed: int = 0, device=None, verbose: bool = False,
                  features: str = "random", positives: str | None = None
                  ) -> np.ndarray:
    """Sweep the neighborhoods of ``dataset`` (cached beside it, as the JAX
    package names the cache) and embed every track -> [n_items, out_dim],
    under the checkpoint's own run config (``checkpoint_config``)."""
    import torch

    from gcn_song_embeddings_tpu_torch.data.device import (
        DeviceGraph,
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        embed_all,
        init_pinsage,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods,
    )
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
        load_jax_checkpoint,
    )
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = checkpoint_config(checkpoint)
    graph = load_graph(dataset, features)
    if graph.features is None:
        raise FileNotFoundError(f"no features found in {dataset}")
    train_pos, _ = graph.load_positives_split(
        positives_path(dataset, positives))
    dg, nb_path = apply_colisten_config(DeviceGraph.from_graph(graph, dev),
                                        train_pos, cfg.walk,
                                        graph.nbhds_path)
    nb_w, nb_n = precompute_neighborhoods(
        dg, cfg.walk, nb_path, seed=cfg.train.seed if checkpoint else seed,
        verbose=verbose)
    mcfg = cfg.model
    if checkpoint:
        params = load_jax_checkpoint(checkpoint, dev)
    else:
        # in_dim tracks the feature matrix, as in the JAX trainer
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_pinsage(gen, mcfg.n_layers, graph.features.shape[1],
                              mcfg.hidden_dim, mcfg.out_dim, mcfg.bias_init)
    emb = embed_all(params, torch.as_tensor(graph.features, device=dev),
                    torch.as_tensor(nb_w, device=dev),
                    torch.as_tensor(nb_n, device=dev), graph.n_items,
                    len(params.layers), mcfg.T)
    return emb.cpu().numpy()


def cmd_embed(args) -> None:
    emb = embed_dataset(args.dataset, args.checkpoint, args.seed,
                        args.device, verbose=True, features=args.features,
                        positives=args.positives)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.save(args.out, emb)
    print(f"embeddings {emb.shape} -> {args.out}")


def eval_models(args, graph, device) -> dict:
    """The eval rows the port has, named as the JAX CLI names them, cut to
    ``--models``; a row the JAX CLI has and the port not yet raises."""
    from gcn_song_embeddings_tpu_torch.models.baselines import (
        EmbLoader,
        PersPageRank,
        Random,
    )

    models = {"Random": Random(),
              "PageRank": PersPageRank(device=device),
              "PageRankCo": PersPageRank(colisten_copies=1, device=device)}
    if graph.features is not None:
        # the raw (not z-normalized) features, from the file the graph's
        # own features came from
        for cand in feature_sources(args.dataset, args.features):
            if os.path.exists(cand):
                models["Features"] = EmbLoader(cand, device=device)
                break
    for run_name in args.pinsage_runs or []:
        models[f"PinSage:{run_name}"] = EmbLoader(
            os.path.join(args.run_dir, run_name, "emb.npy"), device=device)
    later = sorted({*(m for m in args.models or [] if m in NOT_PORTED),
                    *(f"Hybrid:{r}" for r in args.hybrid_runs or [])})
    if later:
        raise SystemExit(f"eval rows {later} are not in the port yet "
                         f"(ROADMAP.md, queue 1 item 4); ported: "
                         f"{sorted(models)}")
    if not args.models:
        print(f"eval: rows left out (not in the port yet, ROADMAP.md queue "
              f"1 item 4): {', '.join(NOT_PORTED)}")
        return models
    unknown = set(args.models) - set(models)
    if unknown:
        raise SystemExit(f"unknown models {sorted(unknown)}; available: "
                         f"{sorted(models)}")
    return {k: v for k, v in models.items() if k in args.models}


def cmd_eval(args) -> None:
    from gcn_song_embeddings_tpu_torch.evals.harness import get_knn_dict
    from gcn_song_embeddings_tpu_torch.evals.tables import (
        compute_beyond_accuracy_table,
        compute_results_table,
    )
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    graph = load_graph(args.dataset, args.features)
    train_pos, test_pos = graph.load_positives_split(
        positives_path(args.dataset, args.positives))
    models = eval_models(args, graph, dev)
    save_dir = args.eval_dir or os.path.join(args.dataset, "baselines")
    knn_dict = get_knn_dict(models, graph, graph.track_ids, train_pos,
                            test_pos, graph.features, save_dir, k=args.k)
    table = compute_results_table(knn_dict, test_pos, graph.in_degrees())
    print(table.to_string())
    table.to_csv(os.path.join(save_dir, "results_accuracy.csv"))
    if graph.features is not None:
        beyond = compute_beyond_accuracy_table(
            knn_dict, test_pos, graph.in_degrees(), graph.features,
            device=dev)
        print(beyond.to_string())
        beyond.to_csv(os.path.join(save_dir, "results_beyond.csv"))
    print(f"results -> {save_dir}")


def cmd_stats(args) -> None:
    graph = load_graph(args.dataset, need_features=False)
    positives = None
    try:
        positives = graph.load_positives(
            positives_path(args.dataset, args.positives))
    except FileNotFoundError:
        if args.positives:
            raise
    print(json.dumps(graph.stats(positives), indent=2))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gcn_song_embeddings_tpu_torch")
    sub = p.add_subparsers(dest="verb", required=True)

    def common(sp, device: bool = True):
        sp.add_argument("--dataset", required=True)
        sp.add_argument("--features", default="random",
                        help="feature model name: features_<name>.npy, "
                             "features.npy or features_<name>/")
        sp.add_argument("--positives", default=None,
                        help="positives filename inside the dataset dir")
        if device:
            sp.add_argument("--device", default=None,
                            help="torch device (default: cuda; 'cpu' on "
                                 "request)")

    sp = sub.add_parser("synth")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--n-tracks", type=int, default=5000)
    sp.add_argument("--n-collections", type=int, default=1000)
    sp.add_argument("--n-positives", type=int, default=20000)
    sp.add_argument("--feature-dim", type=int, default=128)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--hard", action="store_true",
                    help="hierarchical benchmark dataset where the graph "
                         "signal must beat the feature signal "
                         "(data.synth.make_hard_dataset)")
    sp.set_defaults(func=cmd_synth)

    sp = sub.add_parser("train")
    common(sp)
    sp.add_argument("--run-name", default="pinsage_tpu")
    sp.add_argument("--run-dir", default="./runs")
    sp.add_argument("--config", default=None, help="RunConfig json file")
    sp.add_argument("--set", action="append", metavar="KEY=JSON",
                    help="config override, e.g. --set train.lr=0.001")
    sp.add_argument("--no-resume", action="store_true")
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("embed")
    common(sp)
    sp.add_argument("--out", required=True, help="path of the emb.npy")
    sp.add_argument("--checkpoint", default=None,
                    help="trainer checkpoint (state.npz, written by "
                         "either package), embedded under the config.json "
                         "beside it; default: seeded random init at full "
                         "width")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(func=cmd_embed)

    sp = sub.add_parser("eval")
    common(sp)
    sp.add_argument("--run-dir", default="./runs")
    sp.add_argument("--eval-dir", default=None,
                    help="artifact cache and CSVs (default: "
                         "<dataset>/baselines)")
    sp.add_argument("--k", type=int, default=1000)
    sp.add_argument("--pinsage-runs", nargs="*", default=None,
                    help="add PinSage:<run> rows: <run-dir>/<run>/emb.npy")
    sp.add_argument("--hybrid-runs", nargs="*", default=None,
                    help="Hybrid:<run> rows (not in the port yet)")
    sp.add_argument("--models", nargs="*", default=None,
                    help="subset of the rows to evaluate")
    sp.set_defaults(func=cmd_eval)

    sp = sub.add_parser("stats")
    common(sp, device=False)
    sp.set_defaults(func=cmd_stats)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
