"""Command-line entry point of the PyTorch/CUDA port.

Verbs:
  synth  -- write a synthetic dataset in the reference on-disk format
  train  -- PinSage training on one device (co-listen augmentation, PPR
            sweep, sampler, max-margin loss, Adam, chunked checkpoints
            with resume), then the embeddings of every track to
            <run-dir>/<run-name>/emb.npy
  embed  -- PPR neighborhood sweep + full-catalog PinSage embedding
            (``RunConfig.recommended()``), params from a trainer
            checkpoint (either package's) or a seeded init, written to
            one emb.npy

Usage:
  python -m gcn_song_embeddings_tpu_torch.cli synth --dataset DIR
  python -m gcn_song_embeddings_tpu_torch.cli train --dataset DIR \
      [--run-name NAME] [--run-dir ./runs] [--config cfg.json] \
      [--set train.lr=0.001 ...] [--no-resume] [--device cuda]
  python -m gcn_song_embeddings_tpu_torch.cli embed --dataset DIR \
      --out emb.npy [--checkpoint state.npz] [--seed 0] [--device cuda]

Serve the result with ``python -m gcn_song_embeddings_tpu_torch.serve``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def cmd_synth(args) -> None:
    from gcn_song_embeddings_tpu_torch.data.synth import (
        make_synthetic_dataset,
    )

    make_synthetic_dataset(args.dataset, n_tracks=args.n_tracks,
                           n_collections=args.n_collections,
                           n_positives=args.n_positives,
                           feature_dim=args.feature_dim, seed=args.seed)
    print(f"synthetic dataset written to {args.dataset}")


def positives_path(dataset: str) -> str:
    """The dataset's positives file, searched as the JAX CLI does."""
    for name in ("positives_lfm.json", "positives.json"):
        p = os.path.join(dataset, name)
        if os.path.isfile(p):
            return p
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
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
    from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = run_config(args.run_name, args.config, args.set)
    graph = SongGraph(args.dataset,
                      features_file=os.path.join(args.dataset,
                                                 "features.npy"))
    if graph.features is None:
        raise SystemExit(f"no features.npy in {args.dataset}")
    train_pos, _ = graph.load_positives_split(positives_path(args.dataset))
    trainer = PinSageTrainer(DeviceGraph.from_graph(graph, dev),
                             graph.n_items, graph.features, train_pos,
                             cfg=cfg, base_run_dir=args.run_dir,
                             nbhds_path=graph.nbhds_path, log=True,
                             load_save=not args.no_resume)
    trainer.train()
    print(f"embeddings -> {trainer.save_embeddings()}")


def embed_dataset(dataset: str, checkpoint: str | None = None,
                  seed: int = 0, device=None, verbose: bool = False
                  ) -> np.ndarray:
    """Sweep the neighborhoods of ``dataset`` (cached beside it, as the JAX
    package names the cache) and embed every track -> [n_items, out_dim]."""
    import torch

    from gcn_song_embeddings_tpu_torch.config import RunConfig
    from gcn_song_embeddings_tpu_torch.data.device import (
        DeviceGraph,
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
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
    cfg = RunConfig.recommended()
    graph = SongGraph(dataset,
                      features_file=os.path.join(dataset, "features.npy"))
    if graph.features is None:
        raise FileNotFoundError(f"no features.npy in {dataset}")
    train_pos, _ = graph.load_positives_split(
        os.path.join(dataset, "positives.json"))
    dg, nb_path = apply_colisten_config(DeviceGraph.from_graph(graph, dev),
                                        train_pos, cfg.walk,
                                        graph.nbhds_path)
    nb_w, nb_n = precompute_neighborhoods(dg, cfg.walk, nb_path, seed=seed,
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
                        args.device, verbose=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.save(args.out, emb)
    print(f"embeddings {emb.shape} -> {args.out}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gcn_song_embeddings_tpu_torch")
    sub = p.add_subparsers(dest="verb", required=True)

    sp = sub.add_parser("synth")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--n-tracks", type=int, default=5000)
    sp.add_argument("--n-collections", type=int, default=1000)
    sp.add_argument("--n-positives", type=int, default=20000)
    sp.add_argument("--feature-dim", type=int, default=128)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(func=cmd_synth)

    sp = sub.add_parser("train")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--run-name", default="pinsage_tpu")
    sp.add_argument("--run-dir", default="./runs")
    sp.add_argument("--config", default=None, help="RunConfig json file")
    sp.add_argument("--set", action="append", metavar="KEY=JSON",
                    help="config override, e.g. --set train.lr=0.001")
    sp.add_argument("--no-resume", action="store_true")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' on request)")
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("embed")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--out", required=True, help="path of the emb.npy")
    sp.add_argument("--checkpoint", default=None,
                    help="trainer checkpoint (state.npz, written by "
                         "either package); default: seeded random init "
                         "at full width")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' on request)")
    sp.set_defaults(func=cmd_embed)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
