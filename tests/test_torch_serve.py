"""Port's kNN, merge and serving layer vs the JAX package, and the HTTP
surface on the CPU."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.config import WalkConfig as JWalkConfig
from gcn_song_embeddings_tpu.data.device import (
    augment_with_colisten as j_augment,
)
from gcn_song_embeddings_tpu.ops.knn import cosine_topk_block as j_cosine
from gcn_song_embeddings_tpu.ops.merge import merge_topk as j_merge
from gcn_song_embeddings_tpu.ops.ppr import (
    precompute_neighborhoods as j_precompute,
)
from gcn_song_embeddings_tpu.ops.walks import fused_walk_tables as j_tables
from gcn_song_embeddings_tpu.serve import EmbeddingIndex as JEmbeddingIndex
from gcn_song_embeddings_tpu.serve import HybridIndex as JHybridIndex
from gcn_song_embeddings_tpu.serve import _hybrid_topk_batch
from gcn_song_embeddings_tpu_torch import serve as ts
from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    augment_with_colisten,
)
from gcn_song_embeddings_tpu_torch.ops.knn import cosine_topk_block
from gcn_song_embeddings_tpu_torch.ops.merge import merge_topk
from gcn_song_embeddings_tpu_torch.ops.walks import fused_walk_tables


def _emb(n, d=16, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _ids(lists):
    return [[o["index"] for o in r] for r in lists]


def test_cosine_topk_block_matches_jax():
    emb = _emb(300, 24)
    queries = np.arange(0, 300, 7, dtype=np.int32)
    w, n = cosine_topk_block(torch.from_numpy(emb),
                             torch.from_numpy(queries), 10)
    jw, jn = j_cosine(jnp.asarray(emb), jnp.asarray(queries), 10)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))  # no ties


@pytest.mark.parametrize("b,k1,k2,seed", [(6, 8, 8, 0), (5, 12, 6, 1),
                                          (4, 3, 10, 2), (3, 4, 2, 3)])
def test_merge_topk_matches_jax(b, k1, k2, seed):
    """Duplicates across lists, zero-weight head entries, short rows."""
    rng = np.random.default_rng(seed)
    n_nodes = max(k1, k2) + 3
    head_n = np.stack([rng.permutation(n_nodes)[:k1] for _ in range(b)])
    tail_n = np.stack([rng.permutation(n_nodes)[:k2] for _ in range(b)])
    head_w = -np.sort(-rng.random((b, k1)), axis=1).astype(np.float32)
    head_w[:, k1 // 2:] = 0.0
    head_w[0] = 0.0
    tail_w = -np.sort(-rng.normal(size=(b, k2)), axis=1).astype(np.float32)
    args = (head_w, head_n.astype(np.int32), tail_w, tail_n.astype(np.int32))
    w, n = merge_topk(*(torch.from_numpy(a) for a in args))
    jw, jn = j_merge(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_embedding_index_matches_jax():
    emb = _emb(200)
    emb[10] = emb[11]                     # duplicates: self filtered by id
    rows = np.asarray([0, 10, 11, 199, 57], np.int32)
    port = ts.EmbeddingIndex(emb, k_cap=16, device="cpu")
    ref = JEmbeddingIndex(emb, k_cap=16)
    got, want = port.knn_rows(rows, 12), ref.knn_rows(rows, 12)
    for g, w, row in zip(got, want, rows):
        assert [o["score"] for o in g] == [o["score"] for o in w]
        ids = [o["index"] for o in g]
        assert int(row) not in ids and len(ids) == 12
        assert ids == [o["index"] for o in w] or row in (10, 11)
    assert _ids([port.knn(5, 4)]) == _ids([ref.knn(5, 4)])
    assert ts.EmbeddingIndex(emb[:1], device="cpu").knn(0, 10) == []
    assert len(ts.EmbeddingIndex(emb[:2], device="cpu").knn(0, 10)) == 1


def test_hybrid_cached_head_matches_jax(graph, device_graph, positives):
    aug = j_augment(device_graph, positives, 1)
    cfg = JWalkConfig(n_hops=200, t_precompute=12, batch_walkers=128)
    nb = j_precompute(aug, cfg, None, seed=0)
    emb = _emb(graph.n_items, seed=4)
    rows = np.arange(16, dtype=np.int32)
    port = ts.HybridIndex(emb, nbhds=nb, k_cap=16, device="cpu",
                          track_ids=graph.track_ids)
    ref = JHybridIndex(emb, nbhds=nb, k_cap=16, track_ids=graph.track_ids)
    assert _ids(port.knn_rows(rows, 16)) == _ids(ref.knn_rows(rows, 16))
    assert _ids(port.knn_rows(rows, 16)) == _ids(port.knn_rows(rows, 16))


def test_hybrid_live_walk_batch_matches_jax(graph, device_graph, positives):
    """Fed the uniforms of JAX's key, the port's live-walk hybrid batch is
    JAX's `_hybrid_topk_batch`."""
    hops, k, b = 120, 16, 16
    jt = j_tables(j_augment(device_graph, positives, 1))
    tables = fused_walk_tables(augment_with_colisten(
        DeviceGraph.from_graph(graph, "cpu"), positives, 1))
    emb = _emb(graph.n_items, seed=5)
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    rows = np.arange(3, 3 + b, dtype=np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    uniforms = torch.tensor(np.asarray(jax.random.uniform(key, (hops, b, 3))))
    w, n = ts.hybrid_topk_batch(tables, torch.from_numpy(unit),
                                torch.from_numpy(rows), uniforms, hops, 0.85,
                                k, 1)
    jw, jn = _hybrid_topk_batch(jt, jnp.asarray(unit), jnp.asarray(rows),
                                key, hops, 0.85, k, 1)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_hybrid_index_live_walk_serves(graph, positives):
    ix = ts.HybridIndex(_emb(graph.n_items), DeviceGraph.from_graph(
        graph, "cpu"), train_pairs=positives, n_hops=100, k_cap=16,
        device="cpu")
    for row, nbrs in zip([0, 7], ix.knn_rows(np.asarray([0, 7]), 10)):
        ids = [o["index"] for o in nbrs]
        assert len(ids) == len(set(ids)) == 10 and row not in ids
        scores = [o["score"] for o in nbrs]
        assert scores == sorted(scores, reverse=True)
    with pytest.raises(ValueError, match="device_graph"):
        ts.HybridIndex(_emb(10), device="cpu")


def test_later_slices_raise_not_implemented():
    emb = _emb(20)
    with pytest.raises(NotImplementedError, match="int8"):
        ts.EmbeddingIndex(emb, quantized=True, device="cpu")
    ix = ts.EmbeddingIndex(emb, device="cpu")
    for call in (lambda: ix.add_tracks(emb[:1]),
                 lambda: ix.remove_tracks([0]), ix.compact):
        with pytest.raises(NotImplementedError, match="slice"):
            call()
    for flag in ("--int8", "--sharded"):
        with pytest.raises(NotImplementedError, match="slice"):
            ts.main(["--emb", "x.npy", flag, "--device", "cpu"])


def test_http_roundtrip_on_port_0(graph):
    ix = ts.EmbeddingIndex(_emb(graph.n_items), graph.track_ids,
                           graph.tracks, k_cap=16, device="cpu")
    server = ts.serve(ix, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        code, res = get("/healthz")
        assert code == 200 and res["tracks"] == graph.n_items
        tid = graph.track_ids[3]
        code, res = get(f"/knn?track={tid}&k=8")
        assert code == 200 and res["query"] == tid
        assert len(res["neighbors"]) == 8
        assert all(n["track"] != tid for n in res["neighbors"])
        assert res["neighbors"][0]["name"] == graph.tracks[
            res["neighbors"][0]["track"]]["name"]
        assert _ids([res["neighbors"]]) == _ids([ix.knn(3, 8)])
        tids = ",".join(graph.track_ids[i] for i in (1, 4, 9))
        code, res = get(f"/knn?tracks={tids}&k=5")
        assert code == 200 and [len(n) for n in res["neighbors"]] == [5] * 3
        code, res = get("/knn?indices=2,3&k=4")
        assert code == 200 and len(res["neighbors"]) == 2
        code, res = get(f"/embed?track={tid}")
        assert code == 200 and len(res["embedding"]) == 16
        assert get("/knn?track=nope")[0] == 400
        assert get(f"/knn?index={graph.n_items}")[0] == 400
        assert get("/nowhere")[0] == 404
        req = urllib.request.Request(f"http://127.0.0.1:{port}/add",
                                     data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 501
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_query_batcher_coalesces_concurrent_clients():
    """Many threads querying at once each get their own rows' answers."""
    import sys

    ix = ts.EmbeddingIndex(_emb(400), k_cap=8, device="cpu")
    batcher = ts.QueryBatcher(ix, max_batch=16)
    want = {r: _ids([ix.knn(r, 5)])[0] for r in range(40)}
    errors = []

    def client(rows):
        try:
            for r in rows:
                if _ids([batcher.knn(r, 5)])[0] != want[r]:
                    errors.append(r)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client,
                                    args=(range(i, 40, 20),))
                   for i in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        batcher.stop()
    assert errors == []
