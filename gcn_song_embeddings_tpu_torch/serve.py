"""Embedding and hybrid kNN serving over HTTP, on the GPU.

Endpoints (as in the JAX package's serve.py):
    GET /healthz                          -> {"status": "ok", ...}
    GET /knn?track=<id>&k=10              -> ranked neighbors w/ metadata
    GET /knn?index=<row>&k=10             -> same, by integer row
    GET /knn?tracks=<id,id,...>&k=10      -> batched (also indices=)
    GET /embed?track=<id>                 -> the raw (unit) embedding
    POST /add    {"tracks": [{"track", "embedding", "name"?, "artist"?}]}
    POST /remove {"tracks": [<id or row>, ...]}

``EmbeddingIndex`` keeps L2-normalized rows on the device; a batch of
queries is one f32 product (TF32 off) and an exact ``torch.topk``.  With
``quantized=True`` the device holds int8 rows and per-row scales
(``ops/quantize.py``, a quarter of the f32 bytes) and the f32 rows stay on
the host, where the query rows are gathered.  ``HybridIndex`` serves the
walk-head + embedding-tail ranker: in live-walk mode every batch runs
restart walks over the (co-listen augmented) graph through kernel K1, in
cached-head mode it reads the head from the precomputed neighborhoods
artifact; either scores its tail in f32 or int8.  ``ThreadingHTTPServer``
handles sockets on many threads, but all device work, catalog updates
included, funnels through one ``QueryBatcher`` thread that coalesces
concurrent queries into one batch.

Online updates (``EmbeddingIndex`` only): added tracks go to a
power-of-two f32 delta buffer on the device, scored beside the main table
until ``compact()`` folds them in (re-quantizing an int8 table), which
happens by itself past ``max(1024, n_main // 16)`` delta rows.  Removed
tracks are tombstones: their rows are zeroed (on an int8 table values and
scale 0), so they score exactly 0, and they are filtered from results.

Exact ``torch.topk`` replaces the TPU's ``approx_max_k``: the scores are
identical; order among equal scores may differ.  Two faults of the JAX
package's serve.py are not carried over: a tombstoned query row inside a
coalesced hybrid batch yields ``[]`` for that row instead of an error for
the whole batch, and a single query is answered from the k_cap-wide
window, so it keeps k live results while k + tombstones <= k_cap.  Two
more are repaired here: an unbatched server (``serve(index,
batched=False)``) holds the index's ``lock`` around every query and
update, where the JAX package's handler threads race updates against
queries, and ``remove_tracks`` gives a track id the row path's errors
(a second removal is "already removed", a row named twice in one call
raises) where the JAX package reports "unknown track" and dedupes.
Still to come with a later slice of the port: catalog-sharded serving
(``--sharded``).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import warnings
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    augment_with_colisten,
)
from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32
from gcn_song_embeddings_tpu_torch.ops.merge import merge_topk
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    effective_chains,
    visit_counts_topt,
)
from gcn_song_embeddings_tpu_torch.ops.quantize import (
    int8_scores,
    pad_table,
    quantize_rows,
)
from gcn_song_embeddings_tpu_torch.ops.walk_kernel import restart_walks
from gcn_song_embeddings_tpu_torch.ops.walks import (
    chain_origins,
    draw_uniforms,
    fused_walk_tables,
)
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


def hybrid_topk_batch(tables, unit: torch.Tensor, rows: torch.Tensor,
                      uniforms: torch.Tensor, n_hops: int, alpha: float,
                      k: int, n_chains: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B] query rows -> hybrid top-k (weights [B, k], nodes [B, k]):
    restart walks (K1 on the GPU) -> visit-count top-k head, cosine top-k
    tail with the query itself masked, then the ordered merge."""
    trace = restart_walks(tables, rows, n_hops, alpha, uniforms, n_chains)
    head_w, head_n = visit_counts_topt(trace, rows, k)
    return _merge_with_tail(head_w, head_n, _f32_scores(unit, rows), rows, k)


def hybrid_topk_batch_int8(tables, q_values: torch.Tensor,
                           q_scales: torch.Tensor, q: torch.Tensor,
                           rows: torch.Tensor, uniforms: torch.Tensor,
                           n_hops: int, alpha: float, k: int, n_chains: int,
                           n_rows: Optional[int] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``hybrid_topk_batch`` with the tail scored on the int8 table
    (``int8_scores``); ``q`` holds the f32 query rows, gathered on the
    host.  Table rows from ``n_rows`` on (``pad_table``'s) are dropped."""
    trace = restart_walks(tables, rows, n_hops, alpha, uniforms, n_chains)
    head_w, head_n = visit_counts_topt(trace, rows, k)
    sims = int8_scores(q_values, q_scales, q)[:, :n_rows]
    return _merge_with_tail(head_w, head_n, sims, rows, k)


def hybrid_topk_batch_cached(nbhd_w: torch.Tensor, nbhd_n: torch.Tensor,
                             unit: torch.Tensor, rows: torch.Tensor, k: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hybrid top-k with the head read from the precomputed
    neighborhoods artifact: two row gathers, no walk, deterministic."""
    r = rows.long()
    return _merge_with_tail(nbhd_w[r], nbhd_n[r], _f32_scores(unit, rows),
                            rows, k)


def hybrid_topk_batch_cached_int8(nbhd_w: torch.Tensor, nbhd_n: torch.Tensor,
                                  q_values: torch.Tensor,
                                  q_scales: torch.Tensor, q: torch.Tensor,
                                  rows: torch.Tensor, k: int,
                                  n_rows: Optional[int] = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``hybrid_topk_batch_cached`` with the tail scored on the int8
    table, as ``hybrid_topk_batch_int8``."""
    r = rows.long()
    sims = int8_scores(q_values, q_scales, q)[:, :n_rows]
    return _merge_with_tail(nbhd_w[r], nbhd_n[r], sims, rows, k)


def _f32_scores(unit: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    with exact_f32():
        return unit[rows.long()] @ unit.t()


def _merge_with_tail(head_w, head_n, sims, rows, k):
    r = rows.long()
    sims[torch.arange(r.shape[0], device=r.device), r] = float("-inf")
    tail_w, tail_n = torch.topk(sims, k, dim=1)
    return merge_topk(head_w, head_n, tail_w, tail_n)


class TrackResolverMixin:
    """Query-param resolution + result formatting shared by the serving
    indexes: needs ``n``, ``track_ids``, ``row_of``, ``tracks_meta`` and
    ``_tombstones``."""

    def _format_item(self, score: float, idx: int) -> dict:
        tid = self.track_ids[int(idx)]
        item = {"track": tid, "index": int(idx),
                "score": round(float(score), 6)}
        meta = self.tracks_meta.get(tid)
        if meta:
            item["name"] = meta.get("name")
            item["artist"] = meta.get("artist")
        return item

    def _check_row(self, row: int) -> int:
        if not 0 <= row < self.n:
            raise KeyError(f"index {row} out of range")
        if row in self._tombstones:
            raise KeyError(f"index {row} was removed")
        return row

    def resolve(self, params: dict) -> int:
        if "index" in params:
            return self._check_row(int(params["index"][0]))
        tid = params["track"][0]
        if tid not in self.row_of:
            raise KeyError(f"unknown track {tid!r}")
        return self.row_of[tid]

    def resolve_many(self, params: dict) -> list[int]:
        """Comma-separated ``tracks=`` / ``indices=`` query params -> rows."""
        if "indices" in params:
            rows = [self._check_row(int(x))
                    for x in params["indices"][0].split(",") if x]
        else:
            rows = []
            for tid in params["tracks"][0].split(","):
                if tid not in self.row_of:
                    raise KeyError(f"unknown track {tid!r}")
                rows.append(self.row_of[tid])
        if not rows:
            raise ValueError("empty query list")
        return rows


class EmbeddingIndex(TrackResolverMixin):
    """Device-resident cosine kNN index over track embeddings, f32 or int8.

    Every batched query computes the top-(k_cap + 1) list (int8:
    k_cap + 2), so one request asking for k <= k_cap costs the same as any
    other; a single query takes the same path.  An int8 index of at most 2
    tracks scores in exact f32 (the int8 window's slack exceeds it)."""

    def __init__(self, embeddings: np.ndarray,
                 track_ids: Optional[list[str]] = None,
                 tracks_meta: Optional[dict] = None,
                 quantized: bool = False, k_cap: int = 128,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        emb = np.asarray(embeddings, dtype=np.float32)
        # the host copy: /embed and the query rows of an int8 index read
        # it; removals zero its rows too
        self.unit_host = emb / np.maximum(
            np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        self.quantized = quantized
        self.n, self.dim = emb.shape
        self._upload_main()
        self._k_cap_req = k_cap        # re-clamped when the catalog grows
        self.k_cap = max(min(k_cap, self.n - 1), 1)
        self.track_ids = list(track_ids) if track_ids else [
            str(i) for i in range(self.n)]
        self.row_of = {tid: i for i, tid in enumerate(self.track_ids)}
        self.tracks_meta = dict(tracks_meta) if tracks_meta else {}
        self._n_main = self.n
        self._delta_host = np.zeros((0, self.dim), np.float32)
        self._delta_dev = None
        self._tombstones: set[int] = set()
        self._removed_ids: set[str] = set()
        # an unbatched server's handler threads take it around queries and
        # updates (a QueryBatcher serializes them on its own thread)
        self.lock = threading.RLock()

    def _upload_main(self) -> None:
        """The main device table from the host rows: f32 rows, or int8
        rows and scales (quantized on the device, padded to multiples of 8
        for ``_int_mm``) with no f32 copy left on the device."""
        unit = torch.as_tensor(self.unit_host, device=self.device)
        if self.quantized:
            self.q_values, self.q_scales = pad_table(*quantize_rows(unit))
            self.unit = None
        else:
            self.unit = unit

    @classmethod
    def from_run(cls, emb_path: str, graph=None, quantized: bool = False,
                 device: str | torch.device | None = None
                 ) -> "EmbeddingIndex":
        emb = np.load(emb_path)
        if graph is not None:
            return cls(emb, graph.track_ids, graph.tracks,
                       quantized=quantized, device=device)
        return cls(emb, quantized=quantized, device=device)

    def add_tracks(self, embeddings: np.ndarray,
                   track_ids: Optional[list[str]] = None,
                   tracks_meta: Optional[dict] = None) -> list[int]:
        """Append tracks to a live index; returns their new rows.  Their
        unit rows join the delta buffer, scored in f32 beside the main
        table until ``compact()``, which runs by itself once the delta
        holds ``max(1024, n_main // 16)`` rows."""
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected [*, {self.dim}] embeddings, "
                             f"got {emb.shape}")
        m = emb.shape[0]
        if m == 0:
            return []
        ids = (list(track_ids) if track_ids
               else [str(self.n + i) for i in range(m)])
        if len(ids) != m:
            raise ValueError(f"{m} embeddings but {len(ids)} track ids")
        dup = [t for t in ids if t in self.row_of]
        if dup or len(set(ids)) != len(ids):
            raise KeyError(f"duplicate track ids: {(dup or ids)[:3]}")
        unit = emb / np.maximum(
            np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        rows = list(range(self.n, self.n + m))
        self._delta_host = np.concatenate([self._delta_host, unit])
        self.unit_host = np.concatenate([self.unit_host, unit])
        for tid, row in zip(ids, rows):
            self.track_ids.append(tid)
            self.row_of[tid] = row
        if tracks_meta:
            self.tracks_meta.update(tracks_meta)
        self.n += m
        self.k_cap = max(min(self._k_cap_req, self.n - 1), 1)
        if len(self._delta_host) >= max(1024, self._n_main // 16):
            self.compact()
            return rows
        # (re)upload the delta at its power-of-two capacity
        cap = 1 << (len(self._delta_host) - 1).bit_length()
        buf = np.zeros((cap, self.dim), np.float32)
        buf[: len(self._delta_host)] = self._delta_host
        self._delta_dev = torch.as_tensor(buf, device=self.device)
        return rows

    def remove_tracks(self, tracks) -> list[int]:
        """Tombstone tracks (ids or rows) in a live index; returns the
        removed rows.  Their rows are zeroed on the host and the device (an
        int8 row's values and scale), so they score exactly 0, below every
        positively similar candidate; they leave results and id resolution,
        and their rows are never reused.  Either form of an already removed
        track, or a row named twice in one call (as an id and as a row,
        say), raises KeyError and removes nothing."""
        rows = []
        for t in tracks:
            if isinstance(t, str):
                if t not in self.row_of:
                    # a removed id added again resolves to its new row
                    raise KeyError(f"track {t!r} already removed"
                                   if t in self._removed_ids
                                   else f"unknown track {t!r}")
                row = self.row_of[t]
            else:
                row = int(t)
                if not 0 <= row < self.n:
                    raise KeyError(f"index {row} out of range")
                if row in self._tombstones:
                    raise KeyError(f"row {row} already removed")
            rows.append(row)
        if len(set(rows)) != len(rows):
            twice = sorted(r for r in set(rows) if rows.count(r) > 1)
            raise KeyError(f"rows {twice} named twice in one removal")
        rows.sort()
        self._tombstones.update(rows)
        arr = np.asarray(rows, np.int64)
        self.unit_host[arr] = 0.0
        main = arr[arr < self._n_main]
        delta = arr[arr >= self._n_main] - self._n_main
        self._delta_host[delta] = 0.0
        if main.size:
            idx = torch.as_tensor(main, device=self.device)
            if self.quantized:
                self.q_values[idx] = 0
                self.q_scales[idx] = 0.0
            else:
                self.unit[idx] = 0.0
        if delta.size and self._delta_dev is not None:
            self._delta_dev[torch.as_tensor(delta, device=self.device)] = 0.0
        for row in rows:
            self.row_of.pop(self.track_ids[row], None)
            self._removed_ids.add(self.track_ids[row])
        if len(self._tombstones) > self.k_cap // 2:
            warnings.warn(
                f"{len(self._tombstones)} tombstones vs top-k window "
                f"{self.k_cap + 1}: a query keeps k live results only while "
                f"k + tombstones <= {self.k_cap}; rebuild the index to "
                f"reclaim the slots", RuntimeWarning, stacklevel=2)
        return rows

    def compact(self) -> None:
        """Fold the delta into the main device table (re-quantizing an
        int8 table); queries return to the main-table product."""
        if len(self._delta_host) == 0:
            return
        self._upload_main()
        self._n_main = self.n
        self._delta_host = np.zeros((0, self.dim), np.float32)
        self._delta_dev = None

    def knn(self, row: int, k: int = 10) -> list[dict]:
        if row in self._tombstones:
            raise KeyError(f"index {row} was removed")
        return self.knn_rows(np.asarray([row]), k)[0]

    def _format(self, w: np.ndarray, n: np.ndarray, row: int, k: int
                ) -> list[dict]:
        # filter self BY ID: with duplicate embeddings the duplicate can
        # take slot 0 and the query itself slot 1
        keep = n != row
        if self._tombstones:
            keep &= ~np.isin(n, list(self._tombstones))
        return [self._format_item(score, idx)
                for score, idx in zip(w[keep][:k], n[keep][:k])]

    def _check_rows(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        if rows.size and (rows.min() < 0 or rows.max() >= self.n):
            raise IndexError(f"query rows outside [0, {self.n})")
        return rows.astype(np.int32)

    def _host_rows(self, rows: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(self.unit_host[rows], device=self.device)

    def _main_scores(self, q: torch.Tensor) -> torch.Tensor:
        """[B, n_main] scores of f32 query rows against the main table."""
        if self.quantized:
            return int8_scores(self.q_values, self.q_scales,
                               q)[:, :self._n_main]
        with exact_f32():
            return q @ self.unit.t()

    def _topk_rows(self, rows: np.ndarray):
        if self._delta_dev is not None:
            # main table and delta in one top-k: a delta hit's column
            # n_main + position is its global row
            q = self._host_rows(rows)
            with exact_f32():
                sims_d = q @ self._delta_dev.t()
            sims_d[:, len(self._delta_host):] = float("-inf")
            sims = torch.cat([self._main_scores(q), sims_d], dim=1)
            return torch.topk(sims, self.k_cap + 1, dim=1)
        if self.quantized and self.n > 2:
            return torch.topk(self._main_scores(self._host_rows(rows)),
                              min(self.k_cap + 2, self.n), dim=1)
        if self.quantized:                 # tiny: exact f32 on host rows
            with exact_f32():
                sims = self._host_rows(rows) @ self._host_rows(
                    np.arange(self.n)).t()
        else:
            sims = _f32_scores(self.unit, torch.as_tensor(
                rows, device=self.device))
        return torch.topk(sims, min(self.k_cap + 1, self.n), dim=1)

    def knn_rows(self, rows: np.ndarray, k: int = 10) -> list[list[dict]]:
        """Batched kNN: one device call for all query rows.  A tombstoned
        query row yields ``[]`` for that row only, so a removal racing a
        query does not fail the other queries coalesced with it."""
        rows = self._check_rows(rows)
        if rows.size == 0:
            return []
        if self.n <= 1:
            return [[] for _ in rows]
        dead = np.isin(rows, list(self._tombstones))
        k = max(min(k, self.k_cap, self.n - 1), 1)
        w, n = self._topk_rows(rows)
        w, n = w.cpu().numpy(), n.cpu().numpy()
        return [[] if dead[i] else self._format(w[i], n[i], int(rows[i]), k)
                for i in range(rows.size)]

    def embed(self, row: int) -> np.ndarray:
        return np.asarray(self.unit_host[row])


class HybridIndex(EmbeddingIndex):
    """Device-resident hybrid (walk-head + embedding-tail) kNN index.

    Live-walk mode: pass ``device_graph`` (a ``DeviceGraph``) and
    optionally ``train_pairs`` with ``colisten_copies`` >= 1 to add the
    co-listen pseudo-collections first; every batch walks ``n_hops`` hops
    per query through K1, its uniforms drawn from a generator seeded with
    ``seed``.  Cached-head mode: pass ``nbhds=(weights, nodes)``, the
    precomputed neighborhoods artifact.  ``quantized=True`` scores the
    tail on the int8 table.  Removals work as in ``EmbeddingIndex`` (the
    head may still list removed rows; they are filtered); adds do not."""

    def __init__(self, embeddings: np.ndarray, device_graph=None,
                 train_pairs: Optional[np.ndarray] = None,
                 colisten_copies: int = 1,
                 n_hops: int = 1000, alpha: float = 0.85,
                 parallel_chains: int = 1, seed: int = 0,
                 track_ids: Optional[list[str]] = None,
                 tracks_meta: Optional[dict] = None,
                 quantized: bool = False, k_cap: int = 128,
                 nbhds: Optional[tuple] = None,
                 device: str | torch.device | None = None):
        super().__init__(embeddings, track_ids, tracks_meta,
                         quantized=quantized, k_cap=k_cap, device=device)
        self.tables = None
        if nbhds is not None:
            self.nbhd_w = torch.as_tensor(np.asarray(nbhds[0], np.float32),
                                          device=self.device)
            self.nbhd_n = torch.as_tensor(np.asarray(nbhds[1], np.int32),
                                          device=self.device)
            return
        if device_graph is None:
            raise ValueError("HybridIndex needs device_graph (query-time "
                             "walks) or nbhds (precomputed head)")
        g = device_graph
        g = DeviceGraph(*(t.to(self.device) for t in (
            g.i2c_indptr, g.i2c_indices, g.c2i_indptr, g.c2i_indices)))
        if train_pairs is not None and colisten_copies > 0:
            g = augment_with_colisten(g, np.asarray(train_pairs),
                                      colisten_copies)
        self.tables = fused_walk_tables(g)
        self.n_hops = n_hops
        self.alpha = alpha
        self.n_chains = effective_chains(n_hops, parallel_chains)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    def add_tracks(self, embeddings, track_ids=None, tracks_meta=None):
        raise NotImplementedError(
            "online adds are an EmbeddingIndex capability: the hybrid's "
            "walk head needs the new tracks in the graph/neighborhoods "
            "artifact first (ops.ppr.refresh_neighborhoods), then rebuild")

    def _topk_rows(self, rows: np.ndarray):
        r = torch.as_tensor(rows, device=self.device)
        tail = ((self.q_values, self.q_scales, self._host_rows(rows))
                if self.quantized else None)
        if self.tables is None:
            if tail:
                return hybrid_topk_batch_cached_int8(
                    self.nbhd_w, self.nbhd_n, *tail, r, self.k_cap,
                    n_rows=self.n)
            return hybrid_topk_batch_cached(self.nbhd_w, self.nbhd_n,
                                            self.unit, r, self.k_cap)
        origins, hops = chain_origins(r, self.n_hops, self.n_chains)
        uniforms = draw_uniforms(hops, origins.shape[0], self._gen)
        if tail:
            return hybrid_topk_batch_int8(
                self.tables, *tail, r, uniforms, self.n_hops, self.alpha,
                self.k_cap, self.n_chains, n_rows=self.n)
        return hybrid_topk_batch(self.tables, self.unit, r, uniforms,
                                 self.n_hops, self.alpha, self.k_cap,
                                 self.n_chains)


class QueryBatcher:
    """Serializes + coalesces device work behind ONE dispatcher thread.

    Request threads enqueue (rows, k) items and block on a Future; the
    dispatcher drains whatever is queued (up to ``max_batch`` rows), issues
    one batched ``knn_rows`` call and fulfils the futures, so concurrent
    clients ride one device batch.  Catalog updates (``add_tracks``,
    ``remove_tracks``) are device work too: each runs alone, between two
    batches."""

    def __init__(self, index: EmbeddingIndex, max_batch: int = 64):
        self.index = index
        self.max_batch = max_batch
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="knn-dispatch")
        self._thread.start()

    def stop(self, timeout: float | None = 10.0) -> None:
        self._q.put(None)
        self._thread.join(timeout)

    def knn(self, row: int, k: int) -> list[dict]:
        return self.knn_many([row], k)[0]

    def knn_many(self, rows, k: int) -> list[list[dict]]:
        fut: Future = Future()
        self._q.put((list(rows), k, fut))
        return fut.result()

    def _update(self, fn, *args):
        fut: Future = Future()
        self._q.put((fn, args, fut))
        return fut.result()

    def add_tracks(self, emb, track_ids=None, tracks_meta=None) -> list[int]:
        return self._update(self.index.add_tracks, emb, track_ids,
                            tracks_meta)

    def remove_tracks(self, tracks) -> list[int]:
        return self._update(self.index.remove_tracks, tracks)

    @staticmethod
    def _run_update(item) -> None:
        fn, args, fut = item
        try:
            fut.set_result(fn(*args))
        except Exception as e:  # noqa: BLE001 -- the caller gets it
            fut.set_exception(e)

    def _run_batch(self, batch) -> None:
        all_rows = [r for rows, _, _ in batch for r in rows]
        kmax = max(k for _, k, _ in batch)
        try:
            results = self.index.knn_rows(np.asarray(all_rows), kmax)
        except Exception as e:  # noqa: BLE001 -- every waiter gets it
            for _, _, fut in batch:
                fut.set_exception(e)
            return
        off = 0
        for rows, k, fut in batch:
            fut.set_result([nbrs[:k] for nbrs in
                            results[off: off + len(rows)]])
            off += len(rows)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if callable(item[0]):
                self._run_update(item)
                continue
            batch = [item]
            n_rows = len(item[0])
            stop, update = False, None
            while n_rows < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                if callable(nxt[0]):           # after this batch
                    update = nxt
                    break
                batch.append(nxt)
                n_rows += len(nxt[0])
            self._run_batch(batch)
            if update is not None:
                self._run_update(update)
            if stop:
                return


def make_handler(index: EmbeddingIndex, batcher: QueryBatcher | None = None):
    # without a batcher, each request holds the index's lock from
    # resolving its ids to its answer
    guard = contextlib.nullcontext() if batcher else index.lock

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            params = parse_qs(url.query)
            try:
                with guard:
                    code, payload = self._answer(url.path, params)
            except (KeyError, ValueError, IndexError) as e:
                code, payload = 400, {"error": str(e)}
            self._json(code, payload)

        def _answer(self, path: str, params: dict):
            if path == "/healthz":
                return 200, {"status": "ok", "tracks": index.n,
                             "dim": index.dim,
                             "removed": len(index._tombstones)}
            if path == "/knn":
                k = min(int(params.get("k", ["10"])[0]), index.n - 1)
                if "tracks" in params or "indices" in params:
                    rows = index.resolve_many(params)
                    nbrs = (batcher.knn_many(rows, k) if batcher
                            else index.knn_rows(np.asarray(rows), k))
                    return 200, {"queries": [index.track_ids[r]
                                             for r in rows],
                                 "neighbors": nbrs}
                row = index.resolve(params)
                nbrs = batcher.knn(row, k) if batcher else index.knn(row, k)
                return 200, {"query": index.track_ids[row],
                             "neighbors": nbrs}
            if path == "/embed":
                row = index.resolve(params)
                return 200, {"track": index.track_ids[row],
                             "embedding": index.embed(row).tolist()}
            return 404, {"error": f"no route {path}"}

        def do_POST(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            if url.path not in ("/add", "/remove"):
                self._json(404, {"error": f"no route {url.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                tracks = json.loads(self.rfile.read(length))["tracks"]
                with guard:
                    payload = self._update(url.path, tracks)
                code = 200
            except (KeyError, ValueError, TypeError, NotImplementedError,
                    json.JSONDecodeError) as e:
                # TypeError: a malformed payload (ragged embeddings)
                code, payload = 400, {"error": str(e)}
            self._json(code, payload)

        def _update(self, path: str, tracks) -> dict:
            if path == "/remove":
                rows = (batcher.remove_tracks(tracks) if batcher
                        else index.remove_tracks(tracks))
                return {"removed": rows, "tracks": index.n}
            emb = np.asarray([t["embedding"] for t in tracks],
                             dtype=np.float32)
            ids = [t["track"] for t in tracks]
            meta = {t["track"]: {f: t[f] for f in ("name", "artist")
                                 if f in t}
                    for t in tracks if "name" in t or "artist" in t}
            rows = (batcher.add_tracks(emb, ids, meta) if batcher
                    else index.add_tracks(emb, ids, meta))
            return {"added": ids, "rows": rows, "tracks": index.n}

    return Handler


def serve(index: EmbeddingIndex, host: str = "127.0.0.1", port: int = 8800,
          batched: bool = True) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; run ``.serve_forever()`` in a
    thread, then ``.shutdown()`` and ``.server_close()``, which also stops
    the batcher).  ``port=0`` picks a free port
    (``server.server_address[1]``)."""
    batcher = QueryBatcher(index) if batched else None
    server = ThreadingHTTPServer((host, port), make_handler(index, batcher))
    server.batcher = batcher
    if batcher is not None:
        orig_close = server.server_close

        def close_all():
            batcher.stop()
            orig_close()

        server.server_close = close_all
    return server


def cached_head_artifacts(dataset_dir: str, colisten: int,
                          device: torch.device):
    """The cached-head hybrid's inputs for a dataset dir: the graph, the
    train positives, and the neighborhoods artifact swept (or loaded from
    its cache) over the co-listen augmented graph."""
    from gcn_song_embeddings_tpu_torch.config import WalkConfig
    from gcn_song_embeddings_tpu_torch.data.device import (
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods,
    )

    graph = SongGraph(dataset_dir)
    train_pos, _ = graph.load_positives_split(
        os.path.join(dataset_dir, "positives.json"))
    wcfg = WalkConfig(colisten_copies=colisten)
    dg, nb_path = apply_colisten_config(
        DeviceGraph.from_graph(graph, device), train_pos, wcfg,
        os.path.join(dataset_dir, "neighborhoods.npz"))
    nbhds = precompute_neighborhoods(dg, wcfg, nb_path, verbose=True)
    return graph, train_pos, nbhds


def main(argv=None) -> None:
    import argparse

    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph

    ap = argparse.ArgumentParser(prog="gcn_song_embeddings_tpu_torch.serve")
    ap.add_argument("--emb", required=True, help="path to emb.npy")
    ap.add_argument("--dataset", default=None,
                    help="dataset dir for track metadata")
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' on request)")
    ap.add_argument("--hybrid", action="store_true",
                    help="serve the walk-head + embedding-tail ranker "
                         "(requires --dataset)")
    ap.add_argument("--colisten", type=int, default=1,
                    help="colisten copies for the hybrid walk graph")
    ap.add_argument("--hops", type=int, default=1000,
                    help="hybrid walk hops per query")
    ap.add_argument("--chains", type=int, default=1,
                    help="split the hybrid hop budget across this many "
                         "lockstep chains")
    ap.add_argument("--cached-head", action="store_true",
                    help="hybrid walk head from the precomputed "
                         "neighborhoods artifact (swept first if absent)")
    ap.add_argument("--int8", action="store_true",
                    help="serve an int8 table (a quarter of the f32 device "
                         "bytes); the f32 rows stay on the host")
    ap.add_argument("--sharded", action="store_true",
                    help="catalog-sharded serving arrives with a later "
                         "slice of the port")
    args = ap.parse_args(argv)
    if args.sharded:
        raise NotImplementedError("--sharded serving arrives with the "
                                  "sharded-serving slice of the port")
    device = resolve_device(args.device)
    graph = SongGraph(args.dataset) if args.dataset else None
    if args.hybrid:
        if graph is None:
            ap.error("--hybrid requires --dataset (the graph to walk)")
        if args.cached_head:
            graph, _, nbhds = cached_head_artifacts(args.dataset,
                                                    args.colisten, device)
            index = HybridIndex(np.load(args.emb), nbhds=nbhds,
                                track_ids=graph.track_ids,
                                tracks_meta=graph.tracks,
                                quantized=args.int8, device=device)
        else:
            train_pos, _ = graph.load_positives_split(
                os.path.join(args.dataset, "positives.json"))
            index = HybridIndex(
                np.load(args.emb), DeviceGraph.from_graph(graph, device),
                train_pairs=train_pos, colisten_copies=args.colisten,
                n_hops=args.hops, parallel_chains=args.chains,
                track_ids=graph.track_ids, tracks_meta=graph.tracks,
                quantized=args.int8, device=device)
    else:
        index = EmbeddingIndex.from_run(args.emb, graph,
                                        quantized=args.int8, device=device)
    print(f"serving {index.n} tracks on :{args.port} ({device})")
    server = serve(index, port=args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
