"""PinSage parameters as numpy trees, and trainer checkpoints.

A JAX trainer checkpoint is one ``.npz`` holding every pytree leaf under
its key-path string: ``['params'].layers[0].Wq``, ``['params'].G1_w``,
... plus the Adam state (``['opt_state']...``, ignored here) and
``__scalar__`` metadata.  The layouts are the port's too, so a model the
JAX package trained is embedded and served by the port unchanged.

The port's own trainer checkpoint (``save_state``) keeps the params under
those same key paths, so ``load_jax_checkpoint`` (and ``cli embed
--checkpoint``) read it too; its Adam moments and count go under the
port's names (``adam.m.<leaf>``, ``adam.v.<leaf>``, ``adam.count``).
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.models.pinsage import (
    ConvParams,
    PinSageParams,
)
from gcn_song_embeddings_tpu_torch.train.adam import Adam

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


def params_to_numpy(params: PinSageParams) -> dict:
    """Inverse of ``params_from_numpy``: ``{"layers": [{"Wq": ...}, ...],
    "G1_w": ..., "G1_b": ..., "G2_w": ...}`` of numpy arrays."""
    def get(t):
        return t.detach().cpu().numpy()

    return {"layers": [{f: get(getattr(layer, f)) for f in _CONV}
                       for layer in params.layers],
            **{f: get(getattr(params, f)) for f in _HEAD}}


def save_state(path: str, params: PinSageParams, opt: Adam,
               scalars: dict[str, int]) -> None:
    """One atomic ``.npz`` (tmp file + ``os.replace``): params under the
    JAX key paths, the Adam moments and count, ``__scalar__<name>``.
    ``opt`` holds ``params.leaves()`` in that order."""
    payload = {"adam.count": np.asarray(opt.count, dtype=np.int64)}
    for (name, _), m, v in zip(params.leaves(), opt.m, opt.v):
        payload[f"adam.m.{name}"] = m.cpu().numpy()
        payload[f"adam.v.{name}"] = v.cpu().numpy()
    for name, leaf in params.leaves():
        payload[f"['params'].{name}"] = leaf.detach().cpu().numpy()
    for name, value in scalars.items():
        payload["__scalar__" + name] = np.asarray(value)
    atomic_savez(path, **payload)


def atomic_savez(path: str, compressed: bool = False, **arrays) -> None:
    """``np.savez`` (``np.savez_compressed`` if ``compressed``) of
    ``arrays`` to ``path`` through ``<path>.tmp`` and ``os.replace``: a
    process killed mid-write leaves the previous file or none, never a
    truncated one.  A write that raises removes its tmp file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    save = np.savez_compressed if compressed else np.savez
    try:
        with open(tmp, "wb") as f:
            save(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_state(path: str, params: PinSageParams, opt: Adam
               ) -> dict[str, float]:
    """Load a ``save_state`` checkpoint into ``params`` and ``opt`` in
    place; returns its scalars.  A missing leaf raises ``KeyError``, a
    leaf of another shape ``ValueError``."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}

    def take(key, like):
        if key not in stored:
            raise KeyError(f"checkpoint {path} missing leaf {key}")
        arr = stored[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                             f"expected {tuple(like.shape)}")
        return torch.from_numpy(np.asarray(arr, dtype=np.float32))

    with torch.no_grad():
        for (name, leaf), m, v in zip(params.leaves(), opt.m, opt.v):
            leaf.copy_(take(f"['params'].{name}", leaf))
            m.copy_(take(f"adam.m.{name}", m))
            v.copy_(take(f"adam.v.{name}", v))
    if "adam.count" not in stored:
        raise KeyError(f"checkpoint {path} missing leaf adam.count")
    opt.count = int(stored["adam.count"])
    return {k[len("__scalar__"):]: float(v)
            for k, v in stored.items() if k.startswith("__scalar__")}


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
