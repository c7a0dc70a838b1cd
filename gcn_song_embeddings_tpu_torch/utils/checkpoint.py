"""PinSage parameters from the JAX package: numpy trees and checkpoints.

A JAX trainer checkpoint is one ``.npz`` holding every pytree leaf under
its key-path string: ``['params'].layers[0].Wq``, ``['params'].G1_w``,
... plus the Adam state (``['opt_state']...``, ignored here) and
``__scalar__`` metadata.  The layouts are the port's too, so a model the
JAX package trained is embedded and served by the port unchanged.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.models.pinsage import (
    ConvParams,
    PinSageParams,
)

_CONV = ("Wq", "bq", "Ww", "bw")
_HEAD = ("G1_w", "G1_b", "G2_w")
_LAYER_KEY = re.compile(r"^\['params'\]\.layers\[(\d+)\]\.(Wq|bq|Ww|bw)$")
_HEAD_KEY = re.compile(r"^\['params'\]\.(G1_w|G1_b|G2_w)$")


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def params_from_numpy(tree, device: str | torch.device = "cpu"
                      ) -> PinSageParams:
    """The port's parameters from the JAX package's, given as numpy arrays.

    ``tree`` is a JAX ``PinSageParams`` whose leaves were turned into numpy
    arrays, or the same structure as nested dicts/lists (``{"layers":
    [{"Wq": ..., ...}], "G1_w": ..., ...}``)."""
    def put(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    layers = [ConvParams(*(put(_field(layer, f)) for f in _CONV))
              for layer in _field(tree, "layers")]
    return PinSageParams(layers, *(put(_field(tree, f)) for f in _HEAD))


def load_jax_checkpoint(path: str, device: str | torch.device = "cpu"
                        ) -> PinSageParams:
    """PinSage parameters from a JAX trainer checkpoint (``save_pytree``
    npz); the optimizer leaves and scalars are ignored."""
    layers: dict[int, dict[str, np.ndarray]] = {}
    head: dict[str, np.ndarray] = {}
    with np.load(path) as z:
        for key in z.files:
            m = _LAYER_KEY.match(key)
            if m:
                layers.setdefault(int(m.group(1)), {})[m.group(2)] = z[key]
                continue
            m = _HEAD_KEY.match(key)
            if m:
                head[m.group(1)] = z[key]
    if not layers or sorted(layers) != list(range(len(layers))):
        raise KeyError(f"{path}: no consecutive ['params'].layers[i] leaves")
    missing = [f"layers[{i}].{f}" for i, leaf in sorted(layers.items())
               for f in _CONV if f not in leaf]
    missing += [f for f in _HEAD if f not in head]
    if missing:
        raise KeyError(f"{path}: missing parameter leaves {missing}")
    tree = {"layers": [layers[i] for i in range(len(layers))], **head}
    return params_from_numpy(tree, device)
