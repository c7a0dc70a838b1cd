"""Command-line entry point of the PyTorch/CUDA port.

Verbs:
  synth  -- write a synthetic dataset in the reference on-disk format
            (``--hard``: the benchmark where the graph must beat the
            features)
  prepare -- per-track features from the dataset's clips (random, mfcc,
            openl3, vggish (alias vggish2), musicnn; ``--feature-weights``
            loads a net's ``.npz``, else it runs seeded random-init and
            warns) into features_<name>/ and features_<name>.npy; with
            ``--gen-positives`` the PPR sweep (K1) and walk positives into
            positives.json
  train  -- PinSage training on one device (co-listen augmentation, PPR
            sweep, sampler, max-margin loss, Adam, chunked checkpoints
            with resume), then the embeddings of every track to
            <run-dir>/<run-name>/emb.npy
  embed  -- PPR neighborhood sweep + full-catalog PinSage embedding,
            params from a trainer checkpoint (either package's) under the
            ``config.json`` beside it, or a seeded init under
            ``RunConfig.recommended()``, written to one emb.npy
  eval   -- the baseline comparison: every row of the JAX CLI (Random,
            PageRank, PageRankCo, JaccardFast, Node2Vec, TrackTrackCfALS,
            TrackTrackCfBPR, ColTrackCfALS, ColTrackCfLMF, GraphSAGE, GAT,
            GCN, Features, PinSage:<run>, Hybrid:<run>); kNN lists of each
            model cached under --eval-dir, results_accuracy.csv and
            results_beyond.csv
  all    -- prepare, then train, then eval with the PinSage:<run> row
            appended (the reference's ``dashboard.py all``)
  grid   -- PinSage hyperparameter grid search, results sorted by MRR
  stats  -- dataset statistics
  serve  -- the HTTP server; its arguments go to
            ``gcn_song_embeddings_tpu_torch.serve``

Features resolve as in the JAX CLI: ``features_<name>.npy``, then
``features.npy``, then the per-track directory ``features_<name>/``;
positives are ``--positives`` (which must exist) or the first of
``positives_lfm.json`` and ``positives.json``.

Usage:
  python -m gcn_song_embeddings_tpu_torch.cli synth --dataset DIR [--hard]
  python -m gcn_song_embeddings_tpu_torch.cli prepare --dataset DIR \
      [--features random|mfcc|openl3|vggish|musicnn] \
      [--feature-weights W.npz] [--gen-positives] [--seed 0] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli all --dataset DIR \
      [prepare's, train's and eval's options]
  python -m gcn_song_embeddings_tpu_torch.cli train --dataset DIR \
      [--run-name NAME] [--run-dir ./runs] [--config cfg.json] \
      [--set train.lr=0.001 ...] [--no-resume] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli embed --dataset DIR \
      --out emb.npy [--checkpoint state.npz] [--seed 0] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli eval --dataset DIR \
      [--pinsage-runs RUN ...] [--hybrid-runs RUN ...] [--models NAME ...] \
      [--k 1000] [--eval-dir DIR] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli grid --dataset DIR \
      --grid grid.json [--out grid_search.json] [--run-dir ./runs_gs] \
      [--config cfg.json] [--set KEY=JSON ...] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli stats --dataset DIR
  python -m gcn_song_embeddings_tpu_torch.cli serve --emb E.npy [...]

``train --mesh-graph N`` with N > 0 trains sharded (``parallel/``): the
ranks of a ``torch.distributed`` world form a (dp, N) mesh, node tables
row-sharded over N ranks.  Run it under ``torchrun --nproc_per_node K``
(one process per GPU), or alone as a world of one.  ``all --mesh-graph``
runs prepare and eval on rank 0 and trains on every rank.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

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


def feature_embedder(name: str, weights: str | None, seed: int, device):
    """The embedder ``prepare --features name`` runs."""
    from gcn_song_embeddings_tpu_torch import features as F

    if name == "random":
        return F.RandomFeatures(dim=512, seed=seed)
    if name == "mfcc":
        return F.MFCC(device=device)
    if name == "openl3":
        return F.OpenL3(weights_path=weights, seed=seed, device=device)
    if name in ("vggish", "vggish2"):
        # "vggish2" is an alias: the net is AudioSet VGGish and writes
        # features_vggish/ (see features.VGGish)
        return F.VGGish(weights_path=weights, seed=seed, device=device)
    if name == "musicnn":
        return F.MusicNN(weights_path=weights, seed=seed, device=device)
    raise SystemExit(f"unknown feature model {name!r}")


def cmd_prepare(args) -> dict:
    """Features, then (``--gen-positives``) the PPR sweep under
    ``WalkConfig()`` and walk positives in ``positives.json`` (reference
    prepare_dataset, dashboard.py:18-45).  Returns its walls (s)."""
    from gcn_song_embeddings_tpu_torch import features as F
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    walls = {}
    t = time.perf_counter()
    emb = feature_embedder(args.features, args.feature_weights, args.seed,
                           dev)
    F.generate_features(args.dataset, emb)
    walls["features_s"] = time.perf_counter() - t
    print(f"features_{emb.name} generated")
    if args.gen_positives:
        from gcn_song_embeddings_tpu_torch.config import WalkConfig
        from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
        from gcn_song_embeddings_tpu_torch.data.positives import (
            generate_walk_positives,
            indices_to_id_pairs,
        )
        from gcn_song_embeddings_tpu_torch.ops.ppr import (
            precompute_neighborhoods,
        )

        t = time.perf_counter()
        graph = load_graph(args.dataset, need_features=False)
        nbhds = precompute_neighborhoods(
            DeviceGraph.from_graph(graph, dev), WalkConfig(),
            graph.nbhds_path, seed=args.seed, verbose=True)
        walls["sweep_s"] = time.perf_counter() - t
        t = time.perf_counter()
        pairs = indices_to_id_pairs(
            generate_walk_positives(nbhds, graph.n_items, seed=args.seed),
            graph.track_ids)
        out = os.path.join(args.dataset, "positives.json")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(pairs, f)
        walls["positives_s"] = time.perf_counter() - t
        print(f"{len(pairs)} walk positives -> {out}")
    return walls


def cmd_train(args) -> None:
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    if args.mesh_graph:
        cmd_train_sharded(args)
        return
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


def join_world(args):
    """Join the ``torch.distributed`` world (``torchrun``'s, or a world of
    one) and lay it out as a (dp, ``--mesh-graph``) mesh, before any
    work: a mesh that does not fit the world raises here.  Returns (rank,
    mesh)."""
    from gcn_song_embeddings_tpu_torch.parallel import multihost
    from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh

    rank = multihost.initialize_multihost(device=args.device)
    try:
        return rank, make_mesh(n_graph=args.mesh_graph)
    except Exception:
        multihost.shutdown()
        raise


def cmd_train_sharded(args) -> None:
    """``train --mesh-graph N``: every rank of the world (``torchrun``, or
    a world of one) sweeps its share of the neighborhoods (rank 0 writes
    the cache), then ``ShardedTrainer`` trains on a (dp, N) mesh,
    resuming from and checkpointing to ``<run>/state.npz``; rank 0 writes
    ``config.json`` and ``emb.npy``."""
    from gcn_song_embeddings_tpu_torch.data.device import (
        DeviceGraph,
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods_multichip,
    )
    from gcn_song_embeddings_tpu_torch.parallel import multihost
    from gcn_song_embeddings_tpu_torch.parallel.train_step import (
        ShardedTrainer,
    )

    rank, mesh = join_world(args)
    try:
        dev = multihost.rank_device()
        cfg = run_config(args.run_name, args.config, args.set)
        graph = load_graph(args.dataset, args.features)
        if graph.features is None:
            raise SystemExit(f"no features found in {args.dataset}")
        train_pos, _ = graph.load_positives_split(
            positives_path(args.dataset, args.positives))
        dg, nb_path = apply_colisten_config(
            DeviceGraph.from_graph(graph, dev), train_pos, cfg.walk,
            graph.nbhds_path)
        nbhds = precompute_neighborhoods_multichip(
            dg, cfg.walk, nb_path, seed=cfg.train.seed, verbose=rank == 0)
        trainer = ShardedTrainer(mesh, cfg, graph.n_items, graph.features,
                                 nbhds, train_pos)
        run_dir = os.path.join(args.run_dir, cfg.run_name)
        state_path = os.path.join(run_dir, "state.npz")
        if rank == 0:
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                f.write(trainer.cfg.to_json())
        if not args.no_resume:
            trainer.load(state_path)
        trainer.train_epochs(verbose=rank == 0, save_path=state_path)
        trainer.save(state_path)
        emb = trainer.embed()
        if rank == 0:
            path = os.path.join(run_dir, "emb.npy")
            np.save(path, emb)
            print(f"[sharded mesh {mesh.shape}, {dev}] embeddings -> "
                  f"{path}")
    finally:
        multihost.shutdown()


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
    """Every eval row of the JAX CLI, under its names, each on ``device``,
    cut to ``--models``: Random, PageRank, PageRankCo, JaccardFast,
    Node2Vec, the four CF rows, GraphSAGE, GAT, GCN, Features (the raw
    features file), PinSage:<run> per ``--pinsage-runs`` and Hybrid:<run>
    per ``--hybrid-runs``."""
    from gcn_song_embeddings_tpu_torch.models.baselines import (
        ColTrackCF,
        EmbLoader,
        FastNode2Vec,
        GraphSAGE,
        JaccardFast,
        PersPageRank,
        Random,
        TrackTrackCF,
        WalkEmbedHybrid,
    )

    models = {
        "Random": Random(),
        "PageRank": PersPageRank(device=device),
        # walk ranking over the co-listen augmented graph
        "PageRankCo": PersPageRank(colisten_copies=1, device=device),
        "JaccardFast": JaccardFast(device=device),
        "Node2Vec": FastNode2Vec(device=device),
        "TrackTrackCfALS": TrackTrackCF(algo="als", device=device),
        "TrackTrackCfBPR": TrackTrackCF(algo="bpr", device=device),
        "ColTrackCfALS": ColTrackCF(algo="als", device=device),
        "ColTrackCfLMF": ColTrackCF(algo="lmf", device=device),
        "GraphSAGE": GraphSAGE(device=device),
        "GAT": GraphSAGE(layer="gat", device=device),
        "GCN": GraphSAGE(layer="gcn", device=device),
    }
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
    for run_name in args.hybrid_runs or []:
        models[f"Hybrid:{run_name}"] = WalkEmbedHybrid(
            os.path.join(args.run_dir, run_name, "emb.npy"), device=device)
    if args.models:
        unknown = set(args.models) - set(models)
        if unknown:
            raise SystemExit(f"unknown models {sorted(unknown)}; "
                             f"available: {sorted(models)}")
        models = {k: v for k, v in models.items() if k in args.models}
    return models


def run_eval(args, graph, models: dict, device) -> str:
    """Train, cache and score ``models`` on ``graph``'s test positives;
    writes results_accuracy.csv and results_beyond.csv under the eval dir
    and returns it."""
    from gcn_song_embeddings_tpu_torch.evals.harness import get_knn_dict
    from gcn_song_embeddings_tpu_torch.evals.tables import (
        compute_beyond_accuracy_table,
        compute_results_table,
    )

    train_pos, test_pos = graph.load_positives_split(
        positives_path(args.dataset, args.positives))
    save_dir = args.eval_dir or os.path.join(args.dataset, "baselines")
    knn_dict = get_knn_dict(models, graph, graph.track_ids, train_pos,
                            test_pos, graph.features, save_dir, k=args.k)
    table = compute_results_table(knn_dict, test_pos, graph.in_degrees())
    print(table.to_string())
    table.to_csv(os.path.join(save_dir, "results_accuracy.csv"))
    if graph.features is not None:
        beyond = compute_beyond_accuracy_table(
            knn_dict, test_pos, graph.in_degrees(), graph.features,
            device=device)
        print(beyond.to_string())
        beyond.to_csv(os.path.join(save_dir, "results_beyond.csv"))
    print(f"results -> {save_dir}")
    return save_dir


def cmd_eval(args) -> None:
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    graph = load_graph(args.dataset, args.features)
    run_eval(args, graph, eval_models(args, graph, dev), dev)


def cmd_all(args) -> dict:
    """prepare, train, then eval with ``PinSage:<run-name>`` appended
    (``--models`` filters every row, that one too, as in the JAX CLI).
    With ``--mesh-graph`` the world is joined first: rank 0 prepares and
    evaluates, every rank trains.  Returns its walls (s)."""
    if not args.mesh_graph:
        return _all_stages(args, lead=True)
    from gcn_song_embeddings_tpu_torch.parallel import multihost

    try:
        return _all_stages(args, lead=join_world(args)[0] == 0)
    finally:
        multihost.shutdown()


def _all_stages(args, lead: bool) -> dict:
    walls = {}
    t = time.perf_counter()
    if lead:
        walls["prepare"] = cmd_prepare(args)
    if args.mesh_graph:
        from gcn_song_embeddings_tpu_torch.parallel import multihost

        multihost.wait_for_rank_0()       # prepare's files are written
    walls["prepare_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cmd_train(args)
    walls["train_s"] = time.perf_counter() - t
    args.pinsage_runs = (args.pinsage_runs or []) + [args.run_name]
    t = time.perf_counter()
    if lead:
        cmd_eval(args)
    walls["eval_s"] = time.perf_counter() - t
    return walls


def cmd_grid(args) -> None:
    from gcn_song_embeddings_tpu_torch.train.grid_search import grid_search
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    graph = load_graph(args.dataset, args.features)
    if graph.features is None:
        raise SystemExit(f"no features found in {args.dataset}")
    train_pos, test_pos = graph.load_positives_split(
        positives_path(args.dataset, args.positives))
    with open(args.grid) as f:
        grid = json.load(f)
    results = grid_search(graph, train_pos, test_pos, grid,
                          base_cfg=run_config(args.run_name, args.config,
                                              args.set),
                          base_run_dir=args.run_dir, out_path=args.out,
                          device=dev)
    print(json.dumps(results[:5], indent=2))


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


def parser() -> argparse.ArgumentParser:
    """The CLI's argument parser (each verb's ``func`` is its command)."""
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

    def prepare_options(sp):
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--gen-positives", action="store_true",
                        help="PPR sweep and walk positives -> "
                             "positives.json")
        sp.add_argument("--feature-weights", default=None,
                        help="npz weights for openl3/vggish/musicnn "
                             "(models/audio_embedders.py layout); default "
                             "random-init (untrained)")

    def train_options(sp):
        sp.add_argument("--run-name", default="pinsage_tpu")
        sp.add_argument("--run-dir", default="./runs")
        sp.add_argument("--config", default=None,
                        help="RunConfig json file")
        sp.add_argument("--set", action="append", metavar="KEY=JSON",
                        help="config override, e.g. --set train.lr=0.001")
        sp.add_argument("--no-resume", action="store_true")
        sp.add_argument("--mesh-graph", type=int, default=0,
                        help="train sharded over the ranks of a "
                             "torch.distributed world (torchrun, or a "
                             "world of one) with this graph-axis size "
                             "(0 = one device, no process group)")

    def eval_options(sp):
        sp.add_argument("--eval-dir", default=None,
                        help="artifact cache and CSVs (default: "
                             "<dataset>/baselines)")
        sp.add_argument("--k", type=int, default=1000)
        sp.add_argument("--pinsage-runs", nargs="*", default=None,
                        help="add PinSage:<run> rows: "
                             "<run-dir>/<run>/emb.npy")
        sp.add_argument("--hybrid-runs", nargs="*", default=None,
                        help="add Hybrid:<run> rows: walk head + the "
                             "cosine ranking of <run-dir>/<run>/emb.npy")
        sp.add_argument("--models", nargs="*", default=None,
                        help="subset of the rows to evaluate")

    sp = sub.add_parser("prepare")
    common(sp)
    prepare_options(sp)
    sp.set_defaults(func=cmd_prepare)

    sp = sub.add_parser("all")
    common(sp)
    prepare_options(sp)
    train_options(sp)
    eval_options(sp)
    sp.set_defaults(func=cmd_all)

    sp = sub.add_parser("train")
    common(sp)
    train_options(sp)
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
    eval_options(sp)
    sp.set_defaults(func=cmd_eval)

    sp = sub.add_parser("grid")
    common(sp)
    sp.add_argument("--run-name", default="pinsage_tpu")
    sp.add_argument("--run-dir", default="./runs_gs")
    sp.add_argument("--config", default=None, help="RunConfig json file")
    sp.add_argument("--set", action="append", metavar="KEY=JSON",
                    help="config override, e.g. --set train.lr=0.001")
    sp.add_argument("--grid", required=True,
                    help="json file: {param_path: [values, ...]}")
    sp.add_argument("--out", default="grid_search.json")
    sp.set_defaults(func=cmd_grid)

    sp = sub.add_parser("stats")
    common(sp, device=False)
    sp.set_defaults(func=cmd_stats)

    sub.add_parser("serve", add_help=False,
                   help="the HTTP server (gcn_song_embeddings_tpu_torch."
                        "serve; see its --help)")
    return p


def main(argv=None):
    """Run one verb; returns what its command returns (the walls of
    ``prepare`` and ``all``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        # serve owns its argument surface: hand it the rest verbatim
        from gcn_song_embeddings_tpu_torch import serve

        return serve.main(argv[1:])
    args = parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
