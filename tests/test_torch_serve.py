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


def test_later_slices_raise_not_implemented(graph, positives):
    """Catalog-sharded serving is a later slice; the hybrid index takes no
    online adds, as in the JAX package."""
    with pytest.raises(NotImplementedError, match="slice"):
        ts.main(["--emb", "x.npy", "--sharded", "--device", "cpu"])
    ix = ts.HybridIndex(_emb(graph.n_items, 8), DeviceGraph.from_graph(
        graph, "cpu"), train_pairs=positives, n_hops=64, k_cap=16,
        device="cpu")
    with pytest.raises(NotImplementedError, match="refresh_neighborhoods"):
        ix.add_tracks(_emb(1, 8))


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
        for path in ("/add", "/remove"):          # no "tracks": 400
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=b"{}", method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == 400
        code, res = get("/healthz")
        assert res["tracks"] == graph.n_items and res["removed"] == 0
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


# ------------------------------------------------- int8 serving, vs JAX


def _same_up_to_ties(got, want):
    """Equal score lists, and equal ids within each group of equal scores
    (the last group may be cut by k, so only its size is held)."""
    gs, ws = [o["score"] for o in got], [o["score"] for o in want]
    assert gs == ws
    groups = sorted(set(gs), reverse=True)
    for score in groups[:-1]:
        assert ({o["index"] for o in got if o["score"] == score}
                == {o["index"] for o in want if o["score"] == score})


def _unit(e):
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def test_quantized_index_matches_jax(graph):
    """tests/test_serve.py:76 on the port: the int8 index keeps recall
    against f32, and its scores equal the JAX int8 index's (single and
    batched queries: bit-equal int8 math, same 6-digit rounding)."""
    emb = np.random.default_rng(0).normal(
        size=(graph.n_items, 16)).astype(np.float32)
    f32 = ts.EmbeddingIndex(emb, graph.track_ids, graph.tracks, device="cpu")
    port = ts.EmbeddingIndex(emb, graph.track_ids, graph.tracks,
                             quantized=True, device="cpu")
    ref = JEmbeddingIndex(emb, graph.track_ids, graph.tracks, quantized=True)
    assert port.unit is None and port.q_values.dtype == torch.int8
    assert port.q_values.shape == (504, 16)        # rows padded to 8
    recall = 0.0
    for q in range(40):
        got = port.knn(q, 10)
        _same_up_to_ties(got, ref.knn(q, 10))
        want = {o["index"] for o in f32.knn(q, 10)}
        recall += len(want & {o["index"] for o in got}) / 10
    assert recall / 40 > 0.85
    rows = np.asarray([0, 7, 499, 250, 7], np.int32)
    for g, w in zip(port.knn_rows(rows, 12), ref.knn_rows(rows, 12)):
        _same_up_to_ties(g, w)


def test_quantized_tiny_catalogs_match_jax():
    """n <= 2 serves through exact f32 (the int8 window's slack is larger
    than the catalog), as the JAX index does."""
    emb = _emb(3, 8, seed=9)
    for n in (1, 2):
        port = ts.EmbeddingIndex(emb[:n], quantized=True, device="cpu")
        ref = JEmbeddingIndex(emb[:n], quantized=True)
        assert port.knn(0, 10) == ref.knn(0, 10)
        assert port.knn_rows(np.arange(n), 5) == ref.knn_rows(np.arange(n),
                                                              5)
    # at n = 3 the JAX single-query path keeps a slack of 2 and answers
    # one neighbor; the port answers from its batch window, up to n - 1
    assert len(JEmbeddingIndex(emb, quantized=True).knn(0, 5)) == 1
    got = ts.EmbeddingIndex(emb, quantized=True, device="cpu").knn(0, 5)
    assert len(got) == 2 and 0 not in _ids([got])[0]


def test_hybrid_int8_live_walk_batch_matches_jax(graph, device_graph,
                                                 positives):
    """Fed the uniforms of JAX's key, the port's int8 live-walk hybrid
    batch is JAX's `_hybrid_topk_batch_int8` (query rows f32 from the
    host, tail scored on the int8 table)."""
    from gcn_song_embeddings_tpu.ops.quantize import (
        quantize_rows as j_quantize,
    )
    from gcn_song_embeddings_tpu.serve import _hybrid_topk_batch_int8
    from gcn_song_embeddings_tpu_torch.ops.quantize import (
        pad_table,
        quantize_rows,
    )

    hops, k, b = 120, 16, 16
    jt = j_tables(j_augment(device_graph, positives, 1))
    tables = fused_walk_tables(augment_with_colisten(
        DeviceGraph.from_graph(graph, "cpu"), positives, 1))
    unit = _unit(_emb(graph.n_items, seed=6))
    rows = np.arange(5, 5 + b, dtype=np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    uniforms = torch.tensor(np.asarray(jax.random.uniform(key, (hops, b, 3))))
    jv, js = j_quantize(jnp.asarray(unit))
    jw, jn = _hybrid_topk_batch_int8(jt, jv, js, jnp.asarray(unit[rows]),
                                     jnp.asarray(rows), key, hops, 0.85, k, 1)
    values, scales = pad_table(*quantize_rows(torch.from_numpy(unit)))
    w, n = ts.hybrid_topk_batch_int8(
        tables, values, scales, torch.from_numpy(unit[rows]),
        torch.from_numpy(rows), uniforms, hops, 0.85, k, 1,
        n_rows=graph.n_items)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_hybrid_cached_head_int8_matches_jax(graph, device_graph,
                                             positives):
    aug = j_augment(device_graph, positives, 1)
    cfg = JWalkConfig(n_hops=200, t_precompute=12, batch_walkers=128)
    nb = j_precompute(aug, cfg, None, seed=0)
    emb = _emb(graph.n_items, seed=4)
    rows = np.arange(16, dtype=np.int32)
    port = ts.HybridIndex(emb, nbhds=nb, k_cap=16, quantized=True,
                          device="cpu")
    ref = JHybridIndex(emb, nbhds=nb, k_cap=16, quantized=True)
    got, want = port.knn_rows(rows, 16), ref.knn_rows(rows, 16)
    for i, (g, w) in enumerate(zip(got, want)):
        _same_up_to_ties(g, w)
        ids = [o["index"] for o in g]
        assert len(set(ids)) == len(ids) and int(rows[i]) not in ids


def test_hybrid_index_int8_tail(graph, positives):
    """tests/test_serve.py:259 on the port: the same walk head (the same
    generator seed), a tail that differs only by int8 rounding."""
    emb = _emb(graph.n_items, seed=3)
    kw = dict(train_pairs=positives, colisten_copies=1, n_hops=200, seed=0,
              k_cap=16, device="cpu")
    ix = ts.HybridIndex(emb, DeviceGraph.from_graph(graph, "cpu"), **kw)
    qx = ts.HybridIndex(emb, DeviceGraph.from_graph(graph, "cpu"),
                        quantized=True, **kw)
    rows = np.arange(16, dtype=np.int32)
    f32, q = ix.knn_rows(rows, 16), qx.knn_rows(rows, 16)
    overlap = 0.0
    for i in range(len(rows)):
        ids = [o["index"] for o in q[i]]
        assert len(set(ids)) == len(ids) and int(rows[i]) not in ids
        overlap += len(set(ids) & {o["index"] for o in f32[i]}) / len(ids)
    assert overlap / len(rows) > 0.8


# ------------------------------------------- online adds and removals


@pytest.mark.parametrize("quantized", [False, True])
def test_add_tracks_matches_rebuilt_index_and_jax(quantized):
    """tests/test_serve.py:359 on the port, f32 and int8: the delta path
    answers as an index rebuilt with the added rows (f32) and as the JAX
    index given the same adds (the int8 main table scored beside the f32
    delta)."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(300, 16)).astype(np.float32)
    extra = rng.normal(size=(37, 16)).astype(np.float32)
    idx = ts.EmbeddingIndex(base, k_cap=32, quantized=quantized,
                            device="cpu")
    ref = JEmbeddingIndex(base, k_cap=32, quantized=quantized)
    rows = idx.add_tracks(extra)
    assert rows == ref.add_tracks(extra) == list(range(300, 337))
    assert idx.n == 337 and idx._delta_dev.shape == (64, 16)
    queries = np.array([0, 299, 300, 336, 17], np.int32)
    got = idx.knn_rows(queries, k=10)
    for g, w in zip(got, ref.knn_rows(queries, k=10)):
        if quantized:
            _same_up_to_ties(g, w)
        else:
            assert [o["index"] for o in g] == [o["index"] for o in w]
            np.testing.assert_allclose([o["score"] for o in g],
                                       [o["score"] for o in w], atol=2e-6)
    if not quantized:
        fresh = ts.EmbeddingIndex(np.concatenate([base, extra]), k_cap=32,
                                  device="cpu")
        for g, w in zip(got, fresh.knn_rows(queries, k=10)):
            assert [o["index"] for o in g] == [o["index"] for o in w]
            np.testing.assert_allclose([o["score"] for o in g],
                                       [o["score"] for o in w], atol=1e-5)
    assert _ids([idx.knn(312, 8)]) == _ids([ref.knn(312, 8)])


def test_add_tracks_compact_and_incremental_adds():
    rng = np.random.default_rng(12)
    base = rng.normal(size=(200, 8)).astype(np.float32)
    e1 = rng.normal(size=(5, 8)).astype(np.float32)
    e2 = rng.normal(size=(9, 8)).astype(np.float32)
    idx = ts.EmbeddingIndex(base, k_cap=16, device="cpu")
    idx.add_tracks(e1, track_ids=[f"new{i}" for i in range(5)])
    idx.add_tracks(e2)
    before = idx.knn_rows(np.array([3, 203, 210]), k=12)
    idx.compact()
    assert idx._delta_dev is None and idx._n_main == 214
    after = idx.knn_rows(np.array([3, 203, 210]), k=12)
    assert _ids(before) == _ids(after)
    assert idx.row_of["new2"] == 202
    with pytest.raises(KeyError, match="duplicate"):
        idx.add_tracks(e1[:1], track_ids=["new2"])
    with pytest.raises(ValueError, match="expected"):
        idx.add_tracks(rng.normal(size=(2, 5)).astype(np.float32))
    assert idx.add_tracks(np.zeros((0, 8), np.float32)) == []


def test_add_tracks_int8_delta_exact_until_compact():
    """tests/test_serve.py:407 on the port: an added duplicate of row 42
    is found through the exact f32 delta; compact() re-quantizes and
    answers as a fresh int8 index (and as the JAX index after the same
    steps)."""
    rng = np.random.default_rng(13)
    base = rng.normal(size=(400, 16)).astype(np.float32)
    idx = ts.EmbeddingIndex(base, quantized=True, k_cap=16, device="cpu")
    ref = JEmbeddingIndex(base, quantized=True, k_cap=16)
    dup = base[42:43].copy()
    (row,) = idx.add_tracks(dup, track_ids=["dup42"])
    ref.add_tracks(dup, track_ids=["dup42"])
    assert idx.knn(42, 5)[0]["index"] == row
    assert idx.knn(row, 5)[0]["index"] == 42
    idx.compact()
    ref.compact()
    assert idx.q_values.shape == (408, 16) and idx._n_main == 401
    fresh = ts.EmbeddingIndex(np.concatenate([base, dup]), quantized=True,
                              k_cap=16, device="cpu")
    got = idx.knn_rows(np.array([42, row]), k=8)
    assert _ids(got) == _ids(fresh.knn_rows(np.array([42, row]), k=8))
    for g, w in zip(got, ref.knn_rows(np.array([42, row]), k=8)):
        _same_up_to_ties(g, w)


def test_add_tracks_auto_compacts_past_threshold():
    rng = np.random.default_rng(24)
    base = rng.normal(size=(64, 8)).astype(np.float32)
    extra = rng.normal(size=(1030, 8)).astype(np.float32)
    extra[500] = base[5]                     # duplicate planted mid-delta
    for quantized in (False, True):
        idx = ts.EmbeddingIndex(base, k_cap=16, quantized=quantized,
                                device="cpu")
        idx.add_tracks(extra)
        assert idx._delta_dev is None and idx.n == 64 + 1030
        assert idx.knn(5, 5)[0]["index"] == 64 + 500
        assert idx.knn(64 + 500, 5)[0]["index"] == 5
        table = idx.q_values if quantized else idx.unit
        assert table.shape[0] == (1096 if quantized else idx.n)


def test_remove_tracks_tombstones():
    rng = np.random.default_rng(21)
    base = rng.normal(size=(300, 16)).astype(np.float32)
    idx = ts.EmbeddingIndex(base, k_cap=32, device="cpu")
    idx.unit_host[7] = idx.unit_host[3]
    idx.unit = torch.as_tensor(idx.unit_host.copy())
    assert idx.knn(3, 5)[0]["index"] == 7
    assert idx.remove_tracks([7]) == [7]
    assert all(o["index"] != 7 for o in idx.knn(3, 5))
    with pytest.raises(KeyError, match="removed"):
        idx.knn(7, 5)
    with pytest.raises(KeyError, match="already removed"):
        idx.remove_tracks([7])
    with pytest.raises(KeyError, match="removed"):
        idx.resolve({"index": ["7"]})
    idx.add_tracks(base[:2] + 1.0, track_ids=["a1", "a2"])
    assert idx.remove_tracks(["a1"]) == [300]
    assert "a1" not in idx.row_of
    for _ in range(2):                        # before and after compact()
        out = idx.knn_rows(np.array([3, 301]), k=10)
        flat = [o["index"] for row in out for o in row]
        assert 300 not in flat and 7 not in flat
        assert [len(r) for r in out] == [10, 10]
        idx.compact()


def test_remove_tracks_int8_zero_scale():
    rng = np.random.default_rng(22)
    base = rng.normal(size=(256, 16)).astype(np.float32)
    base[9] = base[4]                                # duplicate pair
    idx = ts.EmbeddingIndex(base, quantized=True, k_cap=16, device="cpu")
    ref = JEmbeddingIndex(base, quantized=True, k_cap=16)
    assert idx.knn(4, 5)[0]["index"] == 9
    idx.remove_tracks([9])
    ref.remove_tracks([9])
    out = idx.knn(4, 5)
    assert all(o["index"] != 9 for o in out)
    assert float(idx.q_scales[9]) == 0.0 and not idx.q_values[9].any()
    _same_up_to_ties(out, ref.knn(4, 5))
    from gcn_song_embeddings_tpu_torch.ops.quantize import int8_scores

    scores = int8_scores(idx.q_values, idx.q_scales,
                         torch.from_numpy(idx.unit_host[4:5]))[0]
    assert float(scores[9]) == 0.0


def test_remove_query_returns_empty_in_batch_not_poisoning():
    rng = np.random.default_rng(23)
    idx = ts.EmbeddingIndex(rng.normal(size=(100, 8)).astype(np.float32),
                            k_cap=16, device="cpu")
    idx.remove_tracks([4])
    out = idx.knn_rows(np.array([3, 4, 5]), k=5)
    assert out[1] == [] and len(out[0]) == 5 and len(out[2]) == 5


def test_tiny_catalog_tombstone_returns_empty():
    emb = np.array([[1.0, 0.1], [0.5, 0.5], [0.9, 0.3]], np.float32)
    idx = ts.EmbeddingIndex(emb, device="cpu")
    idx.remove_tracks([1])
    out = idx.knn_rows(np.array([0, 1, 2]), k=1)
    assert out[1] == []
    assert [o["index"] for o in out[0]] == [2]
    assert [o["index"] for o in out[2]] == [0]


def test_hybrid_tombstoned_query_row_in_a_batch_returns_empty(
        graph, device_graph, positives):
    """Fixed fault of the JAX package (serve.py:644-649): a tombstoned row
    in a coalesced hybrid batch fails the whole batch there; the port
    answers [] for that row and serves the others."""
    aug = j_augment(device_graph, positives, 1)
    nb = j_precompute(aug, JWalkConfig(n_hops=200, t_precompute=12,
                                       batch_walkers=128), None, seed=0)
    emb = _emb(graph.n_items, seed=4)
    rows = np.asarray([2, 3, 9])
    for quantized in (False, True):
        ref = JHybridIndex(emb, nbhds=nb, k_cap=16, quantized=quantized)
        ref.remove_tracks([3])
        with pytest.raises(KeyError):
            ref.knn_rows(rows, 8)
        port = ts.HybridIndex(emb, nbhds=nb, k_cap=16, quantized=quantized,
                              device="cpu")
        port.remove_tracks([3])
        out = port.knn_rows(rows, 8)
        assert out[1] == [] and [len(r) for r in out] == [8, 0, 8]
        assert all(o["index"] != 3 for r in out for o in r)
    live = ts.HybridIndex(emb, DeviceGraph.from_graph(graph, "cpu"),
                          train_pairs=positives, n_hops=64, k_cap=16,
                          device="cpu")
    live.remove_tracks([3])
    assert live.knn_rows(rows, 8)[1] == []


@pytest.mark.parametrize("quantized", [False, True])
def test_single_query_keeps_k_live_results_under_tombstones(quantized):
    """Fixed fault of the JAX package (serve.py:483-493): there a single
    query reads a k+1 (int8: k+2) window, and each tombstone inside it
    (score exactly 0, above negative cosines) costs one result.  The port
    answers from the k_cap-wide window: k live results while
    k + tombstones <= k_cap, the brute-force top-k of the live rows."""
    rng = np.random.default_rng(31)
    emb = rng.normal(size=(64, 8)).astype(np.float32)
    emb[1:3] = emb[0] + 0.1 * rng.normal(size=(2, 8))   # two positives
    emb[3:] = -np.abs(emb[3:]) * np.sign(emb[0])        # the rest negative
    removed = [10, 20, 30, 40]
    k = 5
    port = ts.EmbeddingIndex(emb, k_cap=16, quantized=quantized,
                             device="cpu")
    ref = JEmbeddingIndex(emb, k_cap=16, quantized=quantized)
    port.remove_tracks(removed)
    ref.remove_tracks(removed)
    assert len(ref.knn(0, k)) < k                       # the JAX fault
    got = port.knn(0, k)
    assert len(got) == k and _ids([got]) == _ids(port.knn_rows(
        np.asarray([0]), k))
    unit = _unit(emb)
    sims = unit @ unit[0]
    sims[[0, *removed]] = -np.inf
    want = np.argsort(-sims)[:k].tolist()
    if quantized:
        assert len(set(_ids([got])[0]) & set(want)) >= k - 1
    else:
        assert _ids([got])[0] == want


def test_query_batcher_runs_updates_between_batches():
    """Adds and removals go through the dispatcher thread, alone, and
    queries after them see the new catalog."""
    rng = np.random.default_rng(41)
    base = rng.normal(size=(200, 8)).astype(np.float32)
    ix = ts.EmbeddingIndex(base, k_cap=16, quantized=True, device="cpu")
    batcher = ts.QueryBatcher(ix, max_batch=8)
    try:
        (row,) = batcher.add_tracks(base[11:12], ["twin11"], None)
        assert row == 200 and batcher.knn(11, 3)[0]["index"] == 200
        assert batcher.remove_tracks(["twin11"]) == [200]
        assert all(o["index"] != 200 for o in batcher.knn(11, 3))
        with pytest.raises(KeyError):
            batcher.remove_tracks(["twin11"])
        results, errors = {}, []

        def client(q):
            try:
                results[q] = _ids([batcher.knn(q, 4)])[0]
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(q,))
                   for q in range(12)]
        for t in threads:
            t.start()
        batcher.add_tracks(base[20:22] + 0.01, ["a", "b"], None)
        for t in threads:
            t.join(timeout=60)
        assert not errors and len(results) == 12
    finally:
        batcher.stop()


def test_http_add_and_remove_endpoints(graph):
    """tests/test_serve.py:427 and :531 on the port, on an int8 index."""
    emb = np.random.default_rng(0).normal(
        size=(graph.n_items, 16)).astype(np.float32)
    index = ts.EmbeddingIndex(emb, graph.track_ids, graph.tracks,
                              quantized=True, device="cpu")
    server = ts.serve(index, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    def post(path, payload):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(payload).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        vec = (emb[9] / np.linalg.norm(emb[9])).tolist()
        code, res = post("/add", {"tracks": [
            {"track": "brand_new", "embedding": vec, "name": "New Song",
             "artist": "New Artist"}]})
        assert code == 200 and res["added"] == ["brand_new"]
        assert res["rows"] == [graph.n_items]
        assert res["tracks"] == graph.n_items + 1
        code, res = get("/knn?track=brand_new&k=3")
        assert code == 200 and res["neighbors"][0]["index"] == 9
        code, res = get(f"/knn?track={graph.track_ids[9]}&k=3")
        assert res["neighbors"][0]["track"] == "brand_new"
        assert res["neighbors"][0]["name"] == "New Song"
        assert post("/add", {})[0] == 400
        assert post("/add", {"tracks": [{"track": "x",
                                         "embedding": [1.0]}]})[0] == 400
        tid = graph.track_ids[11]
        code, res = post("/remove", {"tracks": [tid]})
        assert code == 200 and res["removed"] == [11]
        assert get("/healthz")[1]["removed"] == 1
        assert get(f"/knn?track={tid}&k=3")[0] == 400
        assert get("/knn?index=11&k=3")[0] == 400
        assert get("/knn?indices=5,11&k=3")[0] == 400
        assert post("/remove", {"tracks": [11]})[0] == 400
        code, res = get("/knn?index=5&k=3")
        assert code == 200 and len(res["neighbors"]) == 3
        assert post("/nowhere", {})[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_main_serves_int8(tmp_path, dataset_dir, monkeypatch):
    """`--int8` builds the quantized index (here on the CPU, on request)
    and hands it to the server."""
    emb_path = tmp_path / "emb.npy"
    np.save(emb_path, _emb(500, 16, seed=2))
    served = {}

    class Server:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def fake_serve(index, port):
        served["index"] = index
        return Server()

    monkeypatch.setattr(ts, "serve", fake_serve)
    ts.main(["--emb", str(emb_path), "--dataset", dataset_dir, "--int8",
             "--device", "cpu"])
    ix = served["index"]
    assert type(ix) is ts.EmbeddingIndex and ix.quantized
    assert len(ix.knn(0, 5)) == 5


def test_remove_by_track_id_errors_as_by_row():
    """Fixed fault of the JAX package (serve.py:335): there a second
    removal by track id reports "unknown track", and an id plus its own
    row in one call dedupes silently.  The port answers as for rows: the
    second removal is "already removed" and a row named twice raises,
    removing nothing."""
    emb = _emb(40, seed=8)
    ids = [f"t{i}" for i in range(40)]
    ref = JEmbeddingIndex(emb, ids, k_cap=8)
    port = ts.EmbeddingIndex(emb, ids, k_cap=8, device="cpu")
    assert ref.remove_tracks(["t5"]) == port.remove_tracks(["t5"]) == [5]
    with pytest.raises(KeyError, match="unknown track"):
        ref.remove_tracks(["t5"])
    with pytest.raises(KeyError, match="already removed"):
        port.remove_tracks(["t5"])
    with pytest.raises(KeyError, match="already removed"):
        port.remove_tracks([5])
    assert ref.remove_tracks(["t6", 6]) == [6]
    for twice in (["t7", 7], [7, 7], ["t7", "t7"]):
        with pytest.raises(KeyError, match="named twice"):
            port.remove_tracks(twice)
    assert 7 not in port._tombstones and port.row_of["t7"] == 7
    assert port.remove_tracks(["t7", 8]) == [7, 8]
    with pytest.raises(KeyError, match="unknown track"):
        port.remove_tracks(["never"])
    # a removed id added again is a live track with a new row
    assert port.add_tracks(_emb(1, seed=10), ["t5"]) == [40]
    assert port.remove_tracks(["t5"]) == [40]
    with pytest.raises(KeyError, match="already removed"):
        port.remove_tracks(["t5"])


def test_unbatched_server_holds_the_index_lock():
    """Fixed fault of the JAX package (serve.py:856): with batched=False
    its handler threads run adds, removals and queries on the index with
    no lock.  The port's handlers take the index's lock around each: a
    request waits while another thread holds it."""
    assert not hasattr(JEmbeddingIndex(_emb(8), k_cap=4), "lock")
    index = ts.EmbeddingIndex(_emb(64, seed=9), k_cap=8, device="cpu")
    server = ts.serve(index, port=0, batched=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    done = {}

    def call(name, req):
        with urllib.request.urlopen(req, timeout=60) as r:
            done[name] = json.loads(r.read())

    try:
        for name, req in (
                ("knn", f"{base}/knn?index=3&k=4"),
                ("remove", urllib.request.Request(
                    f"{base}/remove", data=json.dumps(
                        {"tracks": [10]}).encode())),
                ("add", urllib.request.Request(f"{base}/add", data=json.dumps(
                    {"tracks": [{"track": "new", "embedding":
                                 [1.0] * 16}]}).encode()))):
            with index.lock:
                client = threading.Thread(target=call, args=(name, req))
                client.start()
                client.join(timeout=0.5)
                assert name not in done          # waits for the lock
            client.join(timeout=60)
            assert name in done
        assert len(done["knn"]["neighbors"]) == 4
        assert done["remove"]["removed"] == [10]
        assert done["add"]["rows"] == [64] and index.n == 65
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
