"""Per-track feature files through the native reader (``native/featload.cc``).

A C++ thread pool streams the ``<id>.npy`` vectors (little-endian
contiguous f32 or f64) straight into one [N, d] float32 matrix; Python
resolves id -> path and reads the ``<id>.pt`` files with
``torch.load(weights_only=True)``.  Files the native reader rejects (a
big-endian ``.npy``, say) make the whole directory be read again with
``np.load``, which converts them, so the fast path never byte-swaps.
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import Sequence

import numpy as np

from gcn_song_embeddings_tpu_torch.native import build

_bound = None


def _lib():
    global _bound
    lib = build.library("featload")
    if lib is not None and _bound is not lib:
        lib.fl_probe_dim.restype = ctypes.c_int64
        lib.fl_probe_dim.argtypes = [ctypes.c_char_p]
        lib.fl_load_rows.restype = ctypes.c_int64
        lib.fl_load_rows.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        _bound = lib
    return lib


def native_available() -> bool:
    return _lib() is not None


def load_pt(path: str) -> np.ndarray:
    """One ``.pt`` tensor file as a flat numpy vector."""
    import torch

    return torch.load(path, weights_only=True).numpy().reshape(-1)


def load_feature_rows(features_dir: str, track_ids: Sequence[str]
                      ) -> np.ndarray:
    """Stack per-id feature vectors from ``features_dir`` into [N, d]
    float32 (``.npy`` preferred, ``.pt`` otherwise).  Raises
    FileNotFoundError when an id has neither, ValueError for a file that
    does not load as a [d] vector."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native feature reader cannot be built here "
                           "(no C++ compiler)")
    paths: list[bytes] = []
    pt_rows: list[tuple[int, str]] = []
    probe = None
    for i, tid in enumerate(track_ids):
        npy = os.path.join(features_dir, tid + ".npy")
        if os.path.isfile(npy):
            paths.append(npy.encode())
            probe = probe or npy
            continue
        pt = os.path.join(features_dir, tid + ".pt")
        if os.path.isfile(pt):
            paths.append(b"")
            pt_rows.append((i, pt))
            continue
        raise FileNotFoundError(f"no feature file for track {tid!r} in "
                                f"{features_dir}")

    n = len(paths)
    if probe is not None:
        dim = int(lib.fl_probe_dim(probe.encode()))
        if dim <= 0:
            raise ValueError(f"unreadable .npy header: {probe}")
    elif pt_rows:
        dim = load_pt(pt_rows[0][1]).shape[0]
    else:
        return np.zeros((0, 0), dtype=np.float32)

    out = np.zeros((n, dim), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*paths)
    first_bad = ctypes.c_int64(-1)
    n_bad = lib.fl_load_rows(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dim,
        0, ctypes.byref(first_bad))            # 0 threads: one per core
    if n_bad:
        warnings.warn(
            f"{n_bad} feature files not loadable by the native reader "
            f"(first: {track_ids[first_bad.value]!r}.npy); falling back to "
            f"np.load for the directory {features_dir}")
        for i, path in enumerate(paths):
            if not path:
                continue
            try:
                vec = np.load(path.decode()).reshape(-1)
            except Exception as e:
                raise ValueError(f"feature file failed to load even via "
                                 f"np.load: {path.decode()} ({e!r})") from e
            if vec.shape[0] != dim:
                raise ValueError(f"feature file failed to load as a [{dim}] "
                                 f"vector: {path.decode()} has "
                                 f"{vec.shape[0]} elements")
            out[i] = vec.astype(np.float32)
    for i, pt in pt_rows:
        vec = load_pt(pt)
        if vec.shape[0] != dim:
            raise ValueError(f"feature dim mismatch: {pt} has {vec.shape[0]}, "
                             f"expected {dim}")
        out[i] = vec.astype(np.float32)
    return out
