"""Port's walker (K1's plain version) and PPR sweep vs the JAX package.

Randomness is an input: the port walker is fed the uniforms JAX draws
from a key, ``np.asarray(jax.random.uniform(key, (hops, B, 3)))``, and
must replay JAX's chain bit for bit.  The port's own generator is held
to the JAX suite's distribution checks instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.config import WalkConfig as JWalkConfig
from gcn_song_embeddings_tpu.data.device import DeviceGraph as JDeviceGraph
from gcn_song_embeddings_tpu.ops.pallas_walk import (
    pallas_walks_from_fused_tables,
)
from gcn_song_embeddings_tpu.ops.ppr import (
    precompute_neighborhoods as j_precompute,
    visit_counts_topt as j_visit_counts_topt,
)
from gcn_song_embeddings_tpu.ops.walks import (
    fused_walk_tables as j_tables,
    uniform_slot as j_uniform_slot,
    walks_from_fused_tables as j_walks,
)
from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.ops import walk_kernel
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    effective_chains,
    precompute_neighborhoods,
    visit_counts_topt,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    fused_walk_tables,
    uniform_slot,
    walks_from_fused_tables,
)


def _arrays(n_items=120, n_cols=30, deg=4, seed=0):
    """The small random bipartite graph of tests/test_pallas_walk.py."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_cols, (n_items, deg))
    i2c_indptr = np.arange(n_items + 1, dtype=np.int32) * deg
    src = np.repeat(np.arange(n_items, dtype=np.int32), deg)
    flat = cols.reshape(-1)
    order = np.lexsort((src, flat))
    c2i_indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=n_cols), out=c2i_indptr[1:])
    return i2c_indptr, flat, c2i_indptr.astype(np.int32), src[order]


def _two_hop(dg: DeviceGraph, origin: int) -> set:
    i2c_ptr, i2c_idx = dg.i2c_indptr.numpy(), dg.i2c_indices.numpy()
    c2i_ptr, c2i_idx = dg.c2i_indptr.numpy(), dg.c2i_indices.numpy()
    out = set()
    for c in i2c_idx[i2c_ptr[origin]:i2c_ptr[origin + 1]]:
        out.update(c2i_idx[c2i_ptr[c]:c2i_ptr[c + 1]].tolist())
    return out


@pytest.mark.parametrize("nodeset,hops,alpha,chains,graph_kw", [
    (list(range(24)), 40, 0.85, 1, {}),
    ([5, 0, 63, 17, 17, 2, 31], 25, 0.0, 1,
     dict(n_items=64, n_cols=16, deg=3, seed=3)),
    ([5, 0, 63, 17, 17, 2, 31], 30, 0.85, 2,
     dict(n_items=64, n_cols=16, deg=3, seed=3)),
])
def test_walks_bit_identical_to_jax(nodeset, hops, alpha, chains, graph_kw):
    arrays = _arrays(**graph_kw)
    jt = j_tables(JDeviceGraph.from_arrays(*arrays))
    tables = fused_walk_tables(DeviceGraph.from_arrays(*arrays, device="cpu"))
    key = jax.random.PRNGKey(7 + len(nodeset))
    ns = jnp.asarray(nodeset, dtype=jnp.int32)
    uniforms = torch.tensor(np.asarray(jax.random.uniform(
        key, (hops // chains, len(nodeset) * chains, 3))))
    want = np.asarray(j_walks(jt, ns, hops, alpha, key, n_chains=chains))
    nodes = torch.tensor(nodeset, dtype=torch.int32)
    got = walks_from_fused_tables(tables, nodes, hops, alpha, uniforms,
                                  chains).numpy()
    np.testing.assert_array_equal(got, want)
    # the K1 wrapper takes the plain version on CPU tensors, launching
    # nothing
    before = walk_kernel.launches
    np.testing.assert_array_equal(walk_kernel.restart_walks(
        tables, nodes, hops, alpha, uniforms, chains).numpy(), want)
    assert walk_kernel.launches == before
    if chains == 1:
        pallas = pallas_walks_from_fused_tables(jt, ns, hops, alpha, key,
                                                interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))


def _segment_walks(tables, origins, uniforms, alpha):
    """numpy mirror of K1's schedule (``csrc/walk.cu``): the thread of
    (hop h, walker w) starts a restart segment iff h == 0 or
    u[h-1, w, 2] < f32(alpha), and walks it from the origin's extents up to
    and including the next hop that restarts.  Returns the trace [H, B] and
    how many times each entry was written."""
    origin_ext, i2c_ext, c2i_ext = (t.numpy() for t in tables)
    a = np.float32(alpha)
    hops, b, _ = uniforms.shape
    trace = np.full((hops, b), -1, np.int32)
    writes = np.zeros((hops, b), np.int64)

    def slot(u, deg):   # the f32 product truncated, clamped to deg - 1
        return min(int(np.float32(u) * np.float32(deg)), max(deg - 1, 0))

    for h in range(hops):
        for w in range(b):
            if h > 0 and not uniforms[h - 1, w, 2] < a:
                continue
            start, deg = origin_ext[origins[w]]
            for k in range(h, hops):
                u0, u1, u2 = uniforms[k, w]
                col = i2c_ext[start + slot(u0, deg)]
                row = c2i_ext[col[0] + slot(u1, col[1])]
                trace[k, w] = row[0]
                writes[k, w] += 1
                if u2 < a:
                    break
                start, deg = row[1], row[2]
    return trace, writes


@pytest.mark.parametrize("alpha", [0.0, 0.15, 0.5, 0.85, 1.0])
@pytest.mark.parametrize("nodeset,hops,chains,graph_kw", [
    (list(range(24)), 40, 1, {}),
    ([5, 0, 63, 17, 17, 2, 31], 30, 2,
     dict(n_items=64, n_cols=16, deg=3, seed=3)),
])
def test_segment_schedule_covers_each_hop_once(alpha, nodeset, hops, chains,
                                               graph_kw):
    """K1's decomposition into restart segments writes every trace entry
    exactly once and replays the hop loop (the port's and JAX's) bit for
    bit under JAX's uniforms."""
    arrays = _arrays(**graph_kw)
    tables = fused_walk_tables(DeviceGraph.from_arrays(*arrays, device="cpu"))
    key = jax.random.PRNGKey(11 + len(nodeset))
    uniforms = np.array(jax.random.uniform(
        key, (hops // chains, len(nodeset) * chains, 3)))
    nodes = torch.tensor(nodeset, dtype=torch.int32)
    origins = np.repeat(np.asarray(nodeset, np.int32), chains)
    trace, writes = _segment_walks(tables, origins, uniforms, alpha)
    np.testing.assert_array_equal(writes, 1)
    got = trace.T.reshape(len(nodeset), hops)
    want = walks_from_fused_tables(tables, nodes, hops, alpha,
                                   torch.from_numpy(uniforms), chains)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(j_walks(
        j_tables(JDeviceGraph.from_arrays(*arrays)),
        jnp.asarray(nodeset, dtype=jnp.int32), hops, alpha, key,
        n_chains=chains)))


def test_uniform_slot_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.random(5000, dtype=np.float32),
                        np.float32([0.0, 1 - 2 ** -24, 0.5, 0.999999])])
    u = u.astype(np.float32)
    deg = rng.integers(0, 1 << 20, u.shape[0]).astype(np.int32)
    deg[:8] = [0, 1, 2, 3, 7, 1 << 24, (1 << 24) + 1, 16777217]
    want = np.asarray(j_uniform_slot(jnp.asarray(u), jnp.asarray(deg)))
    got = uniform_slot(torch.from_numpy(u), torch.from_numpy(deg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_chain_split_rejects_non_divisor():
    tables = fused_walk_tables(DeviceGraph.from_arrays(*_arrays(),
                                                       device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        walks_from_fused_tables(tables, torch.arange(4, dtype=torch.int32),
                                50, 0.85, torch.zeros((7, 28, 3)), 7)
    with pytest.raises(ValueError, match="uniforms"):
        walks_from_fused_tables(tables, torch.arange(4, dtype=torch.int32),
                                50, 0.85, torch.zeros((50, 5, 3)))


@pytest.mark.parametrize("alpha,chains", [(0.85, 1), (0.85, 20), (0.3, 1)])
def test_port_rng_walk_distribution_matches_host_simulation(graph, alpha,
                                                            chains):
    """Visit distribution of the port's own generator vs an independent
    numpy simulation of the same chain (tests/test_walks_ppr.py); the
    restart rate alpha shapes it."""
    dg = DeviceGraph.from_graph(graph, "cpu")
    n_hops, origin, B = 2000, 7, 64
    gen = torch.Generator().manual_seed(1)
    trace = walk_kernel.random_walks(
        fused_walk_tables(dg), torch.full((B,), origin, dtype=torch.int32),
        n_hops, alpha, gen, n_chains=chains).numpy()
    p_port = np.bincount(trace.reshape(-1), minlength=dg.n_items) / trace.size

    rng = np.random.default_rng(2)
    i2c_ptr, i2c_idx = graph.i2c.indptr, graph.i2c.indices
    c2i_ptr, c2i_idx = graph.c2i.indptr, graph.c2i.indices
    counts = np.zeros(dg.n_items)
    cur = origin
    for _ in range(n_hops * B):
        col = i2c_idx[rng.integers(i2c_ptr[cur], i2c_ptr[cur + 1])]
        cur = c2i_idx[rng.integers(c2i_ptr[col], c2i_ptr[col + 1])]
        counts[cur] += 1
        if rng.random() < alpha:
            cur = origin
    tv = 0.5 * np.abs(p_port - counts / counts.sum()).sum()
    assert tv < 0.05, f"total variation {tv}"


@pytest.mark.parametrize("chains", [1, 10])
def test_port_rng_restart_always_stays_two_hop(graph, chains):
    """alpha=1 restarts after every hop: the trace support is exactly
    within the origin's 2-hop neighborhood."""
    dg = DeviceGraph.from_graph(graph, "cpu")
    trace = walk_kernel.random_walks(
        fused_walk_tables(dg), torch.full((8,), 11, dtype=torch.int32), 200,
        1.0, torch.Generator().manual_seed(3), n_chains=chains).numpy()
    assert set(np.unique(trace).tolist()) <= _two_hop(dg, 11)


@pytest.mark.parametrize("B,H,N,T", [(16, 64, 40, 5), (9, 30, 12, 20),
                                     (6, 8, 50, 12)])
def test_visit_counts_topt_exact_vs_jax(B, H, N, T):
    """Same traces -> the same top-T weights AND node ids, tie order and
    zero-weight tail included (T=20 > distinct visits, T=12 > H=8)."""
    rng = np.random.default_rng(B * H)
    trace = rng.integers(0, N, size=(B, H)).astype(np.int32)
    nodeset = rng.integers(0, N, size=(B,)).astype(np.int32)
    jw, jn = j_visit_counts_topt(jnp.asarray(trace), jnp.asarray(nodeset), T)
    w, n = visit_counts_topt(torch.from_numpy(trace),
                             torch.from_numpy(nodeset), T)
    assert w.dtype == torch.float32 and n.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_effective_chains():
    assert effective_chains(500, 20) == 20
    assert effective_chains(500, 24) == 20
    assert effective_chains(513, 20) == 19
    assert effective_chains(7, 1) == 1
    assert effective_chains(100, 1000) == 100


def test_neighborhood_cache_cross_loads(graph, device_graph, tmp_path):
    """A cache written by either package loads in the other, bit for bit
    (same .npz keys and provenance meta)."""
    kw = dict(n_hops=60, t_precompute=8, batch_walkers=128)
    dg = DeviceGraph.from_graph(graph, "cpu")
    jax_path = str(tmp_path / "jax.npz")
    jw, jn = j_precompute(device_graph, JWalkConfig(**kw), jax_path, seed=0)
    w, n = precompute_neighborhoods(dg, WalkConfig(**kw), jax_path, seed=5)
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(n, np.asarray(jn))

    port_path = str(tmp_path / "port.npz")
    pw, pn = precompute_neighborhoods(dg, WalkConfig(**kw), port_path)
    jw2, jn2 = j_precompute(device_graph, JWalkConfig(**kw), port_path,
                            seed=9)
    np.testing.assert_array_equal(np.asarray(jw2), pw)
    np.testing.assert_array_equal(np.asarray(jn2), pn)
    # another alpha is another artifact: recomputed, not served stale
    w3, _ = precompute_neighborhoods(dg, WalkConfig(alpha=0.5, **kw),
                                     port_path)
    assert not np.array_equal(w3, pw)


@pytest.mark.parametrize("bad_id", [-1, "n_items"])
def test_neighborhood_cache_with_bad_ids_is_recomputed(graph, tmp_path,
                                                       bad_id):
    """A cache whose ids leave [0, n_items) is refused and rebuilt, never
    handed to the kernels that index with them."""
    cfg = WalkConfig(n_hops=60, t_precompute=8, batch_walkers=128)
    dg = DeviceGraph.from_graph(graph, "cpu")
    path = str(tmp_path / "nb.npz")
    w, n = precompute_neighborhoods(dg, cfg, path, seed=0)
    with np.load(path) as z:
        saved = {k: z[k] for k in z.files}
    saved["nodes"] = saved["nodes"].copy()
    saved["nodes"][3, 0] = graph.n_items if bad_id == "n_items" else bad_id
    np.savez_compressed(path, **saved)
    w2, n2 = precompute_neighborhoods(dg, cfg, path, seed=0)
    np.testing.assert_array_equal(w2, w)
    np.testing.assert_array_equal(n2, n)
    with np.load(path) as z:   # the rebuilt artifact replaced the bad one
        np.testing.assert_array_equal(z["nodes"], n)


def test_port_sweep_properties(graph):
    dg = DeviceGraph.from_graph(graph, "cpu")
    cfg = WalkConfig(n_hops=100, t_precompute=10, batch_walkers=96)
    w, n = precompute_neighborhoods(dg, cfg, None, seed=1)
    assert w.shape == n.shape == (graph.n_items, 10)
    assert w.dtype == np.float32 and n.dtype == np.int32
    assert (np.diff(w, axis=1) <= 0).all()
    assert (w >= 0).all() and (w <= 1).all()
    for i in range(graph.n_items):
        assert i not in set(n[i][w[i] > 0].tolist())
    # per-block generators seeded from (seed, block start): reproducible
    w2, n2 = precompute_neighborhoods(dg, cfg, None, seed=1)
    np.testing.assert_array_equal(w, w2)
    np.testing.assert_array_equal(n, n2)
