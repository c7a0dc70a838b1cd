"""Command-line entry point of the PyTorch/CUDA port.

Verbs:
  synth  -- write a synthetic dataset in the reference on-disk format
  embed  -- PPR neighborhood sweep + full-catalog PinSage embedding
            (``RunConfig.recommended()``), params from a JAX trainer
            checkpoint or a seeded init, written to one emb.npy

Usage:
  python -m gcn_song_embeddings_tpu_torch.cli synth --dataset DIR
  python -m gcn_song_embeddings_tpu_torch.cli embed --dataset DIR \
      --out emb.npy [--checkpoint state.npz] [--seed 0] [--device cuda]

Serve the result with ``python -m gcn_song_embeddings_tpu_torch.serve``.
"""

from __future__ import annotations

import argparse
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

    sp = sub.add_parser("embed")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--out", required=True, help="path of the emb.npy")
    sp.add_argument("--checkpoint", default=None,
                    help="JAX trainer checkpoint (state.npz); default: "
                         "seeded random init at full width")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' on request)")
    sp.set_defaults(func=cmd_embed)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
