"""Evaluation harness: per-model precompute, artifact cache, lazy access
(own copy of gcn_song_embeddings_tpu/evals/harness.py).

Each model is trained once, its embeddings and top-k kNN lists are cached
under the model's name, and a lazy dict loads them on demand; the train,
embed and kNN times are kept with the kNN artifact.  The layout is the
JAX package's, so each package reads the other's cache:

    emb/<model>.npy   [N, d] embeddings (EmbeddingModels only)
    knn/<model>.npz   knn_w [N, K] f32, knn_n [N, K] i32,
                      train_time, emb_time, knn_time scalars
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping

import numpy as np

from gcn_song_embeddings_tpu_torch.models.baselines.base import (
    EmbeddingModel,
    PredictionModel,
)

PRECOMP_K = 1000  # reference eval.py:31
# threads that compress finished rows' kNN caches while the next rows
# train (zlib releases the GIL); one cache takes seconds at 100k x 100
KNN_WRITERS = 4


def precompute_model(model: PredictionModel, model_name: str, graph, ids,
                     train_pos, test_pos, features, save_dir: str,
                     k: int = PRECOMP_K, knn_batch: int = 1000,
                     verbose: bool = True, write=None):
    """Train + cache one model's embeddings and kNN lists if not cached
    (reference precompute_model, eval.py:52-71).  ``write(fn, *args,
    **kwargs)`` runs the compressed kNN cache write (default: here) and
    its result is returned, e.g. ``ThreadPoolExecutor.submit``'s future;
    None where the row was cached already or written here."""
    knn_path = os.path.join(save_dir, "knn", model_name + ".npz")
    if os.path.isfile(knn_path):
        return None

    if verbose:
        print(f"Training {model_name}...")
    t0 = time.time()
    model.train(graph, ids, train_pos, test_pos, features)
    train_time = time.time() - t0

    emb_time = 0.0
    if isinstance(model, EmbeddingModel):
        emb_dir = os.path.join(save_dir, "emb")
        os.makedirs(emb_dir, exist_ok=True)
        emb_path = os.path.join(emb_dir, model_name + ".npy")
        if not os.path.isfile(emb_path):
            t0 = time.time()
            emb = model.embed(np.arange(len(ids), dtype=np.int64))
            emb_time = time.time() - t0
            np.save(emb_path, np.asarray(emb))

    # kNN sweep in batches (reference save_knn, eval.py:112-143)
    k = min(k, len(ids) - 1)
    n = len(ids)
    all_nodes = np.arange(n, dtype=np.int32)
    w_list, n_list = [], []
    knn_time = 0.0
    for start in range(0, n, knn_batch):
        stop = min(start + knn_batch, n)
        t0 = time.time()
        w, nn = model.knn(all_nodes[start:stop], k)
        knn_time += time.time() - t0
        w_list.append(np.asarray(w))
        n_list.append(np.asarray(nn))
        if verbose and n > knn_batch:
            print(f"  knn {stop}/{n}")
    os.makedirs(os.path.dirname(knn_path), exist_ok=True)
    arrays = dict(knn_w=np.concatenate(w_list, 0).astype(np.float32),
                  knn_n=np.concatenate(n_list, 0).astype(np.int32),
                  train_time=train_time, emb_time=emb_time,
                  knn_time=knn_time)
    if write is None:
        np.savez_compressed(knn_path, **arrays)
        return None
    return write(np.savez_compressed, knn_path, **arrays)


def load_knn(model_name: str, save_dir: str):
    path = os.path.join(save_dir, "knn", model_name + ".npz")
    with np.load(path) as z:
        return (z["knn_w"], z["knn_n"].astype(np.int64),
                float(z["train_time"]), float(z["emb_time"]),
                float(z["knn_time"]))


def load_embedding(model_name: str, save_dir: str) -> np.ndarray:
    return np.load(os.path.join(save_dir, "emb", model_name + ".npy"))


class LazyKnnDict(Mapping):
    """Lazy {model_name: (knn_w, knn_n)} view over the artifact cache
    (reference LazyKnnDict, eval.py:177-215)."""

    def __init__(self, model_names: list[str], save_dir: str):
        self.model_names = list(model_names)
        self.save_dir = save_dir
        self._times: dict[str, tuple[float, float, float]] = {}

    def __getitem__(self, name: str):
        w, n, tt, et, kt = load_knn(name, self.save_dir)
        self._times[name] = (tt, et, kt)
        return w, n

    def get_times(self, name: str) -> tuple[float, float, float]:
        if name not in self._times:
            self[name]
        return self._times[name]

    def __iter__(self):
        return iter(self.model_names)

    def __len__(self):
        return len(self.model_names)


def get_knn_dict(models: dict[str, PredictionModel], graph, ids, train_pos,
                 test_pos, features, save_dir: str, k: int = PRECOMP_K,
                 verbose: bool = True) -> LazyKnnDict:
    """Precompute every model then return the lazy cache view
    (reference get_knn_dict, eval.py:166-175).  Each row's kNN cache is
    compressed on one of ``KNN_WRITERS`` threads while the next rows run;
    every write has finished (and any error of one is raised) before the
    view is returned."""
    with ThreadPoolExecutor(max_workers=KNN_WRITERS) as pool:
        pending = [precompute_model(model, name, graph, ids, train_pos,
                                    test_pos, features, save_dir, k=k,
                                    verbose=verbose, write=pool.submit)
                   for name, model in models.items()]
        for future in pending:
            if future is not None:
                future.result()
    return LazyKnnDict(list(models.keys()), save_dir)
