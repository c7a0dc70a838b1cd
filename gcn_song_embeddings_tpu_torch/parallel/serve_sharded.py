"""Catalog-sharded serving: distributed kNN and hybrid retrieval over the
ranks of a ``graph`` process group
(gcn_song_embeddings_tpu/parallel/serve_sharded.py on
``torch.distributed``).

``serve.py`` keeps the whole [N, d] table (and the hybrid's [N, T]
neighborhoods) on one device.  Here the tables are row-sharded over the
ranks and a batch of queries runs the distributed-MIPS schedule:

    1. gather the query rows from the sharded table (the sharded table
       gather of ``parallel/gather.py``; an int8 index takes them from
       its host copy instead),
    2. every rank scores the queries against ITS shard (one exact f32
       product, or ``ops.quantize.int8_scores``) with the query's own
       row and the pad rows masked to -inf, and takes a local top-k,
    3. ``all_gather`` the [g, B, k] candidates,
    4. re-rank the g * k candidates with one top-k, on every rank.

The scores are those of the single-device indexes (``serve.EmbeddingIndex``
and ``HybridIndex``), so results match up to ties.  The cached-head
hybrid gathers each query's head row from the sharded neighborhoods and
merges it with the re-ranked tail (``ops.merge.merge_topk``).

Rank discipline: every rank enters the same collectives in the same
order.  ``knn_rows`` and ``hybrid_knn_rows`` are collective (every rank
calls them with the same rows).  Under HTTP, rank 0 serves
(``ShardedServingFrontend`` under ``serve.serve``) and broadcasts each
batch's op and rows before computing it; the other ranks sit in
``ShardedServeIndex.follow`` until rank 0's ``close`` broadcasts the
stop.  Those broadcasts ride ``multihost.control_group`` (gloo, CPU
tensors, a year's timeout), so a server may idle between requests for
longer than the compute groups' timeout.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32
from gcn_song_embeddings_tpu_torch.ops.merge import merge_topk
from gcn_song_embeddings_tpu_torch.ops.quantize import (
    int8_scores,
    pad_table,
    quantize_rows,
)
from gcn_song_embeddings_tpu_torch.parallel import collectives as C
from gcn_song_embeddings_tpu_torch.parallel import multihost
from gcn_song_embeddings_tpu_torch.parallel.gather import gather_fn
from gcn_song_embeddings_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pad_to_multiple,
)
from gcn_song_embeddings_tpu_torch.serve import TrackResolverMixin

_STOP, _KNN, _HYBRID = 0, 1, 2


def _rerank(w_loc: torch.Tensor, i_loc: torch.Tensor, k: int, group
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """all_gather the local [B, k] candidates and re-rank them to the
    global top-k (the same on every rank)."""
    w_all, n_all = C.all_gather(w_loc, group), C.all_gather(i_loc, group)
    g, b = w_all.shape[:2]
    w_cat = w_all.permute(1, 0, 2).reshape(b, g * k)
    n_cat = n_all.permute(1, 0, 2).reshape(b, g * k)
    w, idx = torch.topk(w_cat, k, dim=1)
    return w, torch.gather(n_cat, 1, idx)


class ShardedServeIndex:
    """Serving index with the catalog row-sharded over a mesh whose dp
    axis has size 1 (None: ``make_mesh(n_dp=1)`` over the world).

    ``nbhds=(weights [N, T], nodes [N, T])`` enables
    ``hybrid_knn_rows`` (cached walk head).  ``quantized=True`` scores on
    an int8 table: each rank quantizes its own rows (round to nearest,
    ``ops.quantize.quantize_rows``) and keeps no f32 copy on its device;
    query rows come from the host copy.  ``k_cap`` is the top-k width of
    every call, clamped to the rows a shard holds."""

    def __init__(self, embeddings: np.ndarray, mesh: Optional[Mesh] = None,
                 nbhds: Optional[tuple] = None, quantized: bool = False,
                 k_cap: int = 128, gather_impl: str = "psum_scatter"):
        self._gather = gather_fn(gather_impl)
        mesh = mesh if mesh is not None else make_mesh(n_dp=1)
        if mesh.n_dp != 1:
            raise ValueError(f"serving mesh axis 'dp' must have size 1 (got "
                             f"{mesh.n_dp}): dp has no meaning here")
        self.mesh, self.group, self.device = (mesh, mesh.graph_group,
                                              mesh.device)
        g, gi = mesh.n_graph, mesh.graph_index
        emb = np.asarray(embeddings, dtype=np.float32)
        self.n, self.dim = emb.shape
        unit = emb / np.maximum(
            np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        n_pad = pad_to_multiple(self.n, g)
        self.rows_local = rows = n_pad // g
        k_cap = min(k_cap, max(rows, 1))
        self.k_cap = min(k_cap, self.n - 1) if self.n > 1 else 1
        padded = np.zeros((n_pad, self.dim), np.float32)
        padded[:self.n] = unit
        self.unit_host = padded[:self.n]   # /embed and int8 query rows
        mine = slice(gi * rows, (gi + 1) * rows)
        shard = torch.as_tensor(padded[mine].copy(), device=self.device)
        self.quantized = quantized
        if quantized:
            self.q_values, self.q_scales = pad_table(*quantize_rows(shard))
            self.unit = None
        else:
            self.unit = shard
        self.nbhds = None
        if nbhds is not None:
            w = np.zeros((n_pad, nbhds[0].shape[1]), np.float32)
            w[:self.n] = nbhds[0]
            nn = np.zeros((n_pad, nbhds[1].shape[1]), np.int32)
            nn[:self.n] = nbhds[1]
            self.nbhds = (torch.as_tensor(w[mine].copy(), device=self.device),
                          torch.as_tensor(nn[mine].copy(), device=self.device))

    # ------------------------------------------------------ device work

    def _scores(self, rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """[B, rows_local] scores of the queries against the local shard,
        the query's own row and the pad rows at -inf."""
        if self.quantized:
            sims = int8_scores(self.q_values, self.q_scales,
                               q)[:, :self.rows_local]
        else:
            with exact_f32():
                sims = q @ self.unit.t()
        cols = (self.mesh.graph_index * self.rows_local
                + torch.arange(self.rows_local, device=self.device))
        drop = (cols[None, :] == rows.long()[:, None]) | (
            cols >= self.n)[None, :]
        return sims.masked_fill(drop, float("-inf"))

    def _tail(self, rows: torch.Tensor, host_rows: np.ndarray):
        if self.quantized:
            q = torch.as_tensor(self.unit_host[host_rows], device=self.device)
        else:
            q = self._gather(self.unit, rows, self.group)       # [B, d]
        w_loc, i_loc = torch.topk(self._scores(rows, q), self.k_cap, dim=1)
        i_loc = i_loc + self.mesh.graph_index * self.rows_local
        return _rerank(w_loc, i_loc, self.k_cap, self.group)

    def _run(self, op: int, padded: np.ndarray):
        rows = torch.as_tensor(padded, device=self.device)
        tail_w, tail_n = self._tail(rows, padded)
        tail_n = tail_n.to(torch.int32)
        if op == _KNN:
            return tail_w, tail_n
        head_w = self._gather(self.nbhds[0], rows, self.group)
        head_n = self._gather(self.nbhds[1], rows, self.group)
        return merge_topk(head_w, head_n, tail_w, tail_n)

    # -------------------------------------------------------------- API

    def _prep_rows(self, rows) -> tuple[np.ndarray, int]:
        rows = np.asarray(rows).reshape(-1)
        if rows.size == 0:
            raise ValueError("empty query batch")
        if rows.min() < 0 or rows.max() >= self.n:
            raise IndexError(f"query rows outside [0, {self.n})")
        b = 1 << (int(rows.size) - 1).bit_length()           # pow2 bucket
        padded = np.zeros((b,), np.int32)
        padded[:rows.size] = rows
        return padded, rows.size

    def _query(self, op: int, rows, k: int, lead: bool):
        if op == _HYBRID and self.nbhds is None:
            raise ValueError("hybrid_knn needs nbhds= at construction")
        k = max(min(k, self.k_cap), 1)
        padded, n_real = self._prep_rows(rows)
        if lead:
            self._announce(op, padded)
        w, n = self._run(op, padded)
        return w.cpu().numpy()[:n_real, :k], n.cpu().numpy()[:n_real, :k]

    def knn_rows(self, rows, k: int = 10, lead: bool = False
                 ) -> tuple[np.ndarray, np.ndarray]:
        """[B] global query rows -> (weights [B, k], nodes [B, k]),
        self-excluded, ranked by cosine (or int8 cosine).  Collective:
        every rank calls it with the same rows, unless rank 0 ``lead``s
        ranks that ``follow``."""
        return self._query(_KNN, rows, k, lead)

    def hybrid_knn_rows(self, rows, k: int = 10, lead: bool = False
                        ) -> tuple[np.ndarray, np.ndarray]:
        """[B] query rows -> hybrid (cached walk head + embedding tail)
        ranking, ``serve.HybridIndex`` cached-head semantics."""
        return self._query(_HYBRID, rows, k, lead)

    @staticmethod
    def _announce(op: int, padded: np.ndarray) -> None:
        """Rank 0: the op and the rows, on the control group."""
        ctrl = multihost.control_group()
        dist.broadcast(torch.tensor([op, padded.size], dtype=torch.int64), 0,
                       group=ctrl)
        if op != _STOP:
            dist.broadcast(torch.from_numpy(padded), 0, group=ctrl)

    def follow(self) -> None:
        """On every rank but 0: receive each batch rank 0 leads and
        compute it with rank 0, until rank 0's ``release``.  The wait
        for the next batch is bounded only by ``multihost.IDLE_TIMEOUT``."""
        ctrl = multihost.control_group()
        while True:
            head = torch.zeros(2, dtype=torch.int64)
            dist.broadcast(head, 0, group=ctrl)
            op, b = (int(x) for x in head)
            if op == _STOP:
                return
            padded = torch.zeros(b, dtype=torch.int32)
            dist.broadcast(padded, 0, group=ctrl)
            self._run(op, padded.numpy())

    def release(self) -> None:
        """On rank 0: end the other ranks' ``follow``."""
        self._announce(_STOP, np.zeros(0, np.int32))


class ShardedServingFrontend(TrackResolverMixin):
    """``serve.py``-compatible facade over a ``ShardedServeIndex``, on
    rank 0: the ``EmbeddingIndex`` query surface (``n``, ``dim``,
    ``track_ids``, ``resolve``, ``resolve_many``, ``knn``, ``knn_rows``,
    ``embed``), so ``serve.serve`` (HTTP, ``QueryBatcher``) runs over the
    sharded index.  Every batch is led to the ranks in
    ``ShardedServeIndex.follow``; ``close`` releases them.  Queries go to
    ``hybrid_knn_rows`` when the index has neighborhoods, else to
    ``knn_rows``.  The catalog is fixed: adds and removals raise."""

    def __init__(self, index: ShardedServeIndex,
                 track_ids: Optional[list] = None,
                 tracks_meta: Optional[dict] = None,
                 hybrid: Optional[bool] = None):
        self.index = index
        self.n, self.dim, self.k_cap = index.n, index.dim, index.k_cap
        self.track_ids = (list(track_ids) if track_ids
                          else [str(i) for i in range(self.n)])
        if len(self.track_ids) != self.n:
            raise ValueError(f"{len(self.track_ids)} track ids for "
                             f"{self.n} catalog rows")
        self.row_of = {tid: i for i, tid in enumerate(self.track_ids)}
        self.tracks_meta = tracks_meta or {}
        self.hybrid = index.nbhds is not None if hybrid is None else hybrid
        if self.hybrid and index.nbhds is None:
            raise ValueError("hybrid=True needs an index built with nbhds=")
        self._tombstones: frozenset = frozenset()
        self.lock = threading.RLock()

    def add_tracks(self, embeddings, track_ids=None, tracks_meta=None):
        raise NotImplementedError(
            "online adds on a sharded index need a re-shard (rows are "
            "range-partitioned); rebuild the ShardedServeIndex, or serve "
            "deltas from a single-device EmbeddingIndex tier")

    def remove_tracks(self, tracks):
        raise NotImplementedError(
            "online removals on a sharded index need a re-shard; "
            "rebuild the ShardedServeIndex without the removed rows")

    def knn(self, row: int, k: int = 10) -> list[dict]:
        return self.knn_rows(np.asarray([row]), k)[0]

    def knn_rows(self, rows, k: int = 10) -> list[list[dict]]:
        rows = np.asarray(rows)
        if rows.size == 0:
            return []
        k = max(min(k, self.k_cap, self.n - 1), 1)
        fn = (self.index.hybrid_knn_rows if self.hybrid
              else self.index.knn_rows)
        w, n = fn(rows, k, lead=True)
        out = []
        for wi, ni in zip(w, n):
            keep = np.isfinite(wi)           # drop degenerate -inf fills
            out.append([self._format_item(score, idx) for score, idx in
                        zip(wi[keep][:k], ni[keep][:k])])
        return out

    def embed(self, row: int) -> np.ndarray:
        return np.asarray(self.index.unit_host[row])

    def close(self) -> None:
        self.index.release()


def serve_main(args, graph) -> None:
    """``serve --sharded``: join the world (``torchrun``, or a world of
    one), shard the catalog over every rank, and serve HTTP from rank 0
    while the others follow.  ``--hybrid`` needs ``--cached-head``."""
    from gcn_song_embeddings_tpu_torch.serve import (
        cached_head_artifacts,
        serve,
    )

    rank = multihost.initialize_multihost(device=args.device)
    try:
        dev = multihost.rank_device()
        nbhds = None
        if args.hybrid:
            graph, _, nbhds = cached_head_artifacts(args.dataset,
                                                    args.colisten, dev)
        index = ShardedServeIndex(np.load(args.emb), nbhds=nbhds,
                                  quantized=args.int8)
        if rank != 0:
            index.follow()
            return
        front = ShardedServingFrontend(
            index, track_ids=graph.track_ids if graph else None,
            tracks_meta=graph.tracks if graph else None)
        front.knn_rows(np.arange(min(2, index.n)), 10)
        server = serve(front, port=args.port)
        # the port bound (``--port 0``: one the system picked)
        print(f"serving {index.n} tracks on :{server.server_address[1]} "
              f"(sharded over {index.mesh.n_graph} ranks, {dev})",
              flush=True)
        try:
            server.serve_forever()
        finally:
            server.server_close()
            front.close()
    finally:
        multihost.shutdown()
