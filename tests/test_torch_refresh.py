"""The port's incremental neighborhood refresh (``ops.ppr.affected_origins``
and ``refresh_neighborhoods``) vs the JAX package, on the CPU.

``affected_origins`` must equal JAX's bit for bit.  The refresh keeps the
unaffected rows bit for bit, agrees with a full re-sweep of the augmented
graph up to walk noise (the refresh-vs-full TV distance over the affected
origins within 1.3x the seed-to-seed TV of two full sweeps + 0.02, the
bar of tests/test_refresh.py), and fed the uniforms JAX draws for each
block it gives JAX's refreshed artifact exactly.  Its artifact is served
by both packages' ``precompute_neighborhoods`` on the augmented graph.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.config import WalkConfig as JWalkConfig
from gcn_song_embeddings_tpu.data.device import (
    augment_with_colisten as j_augment,
)
from gcn_song_embeddings_tpu.ops.ppr import (
    affected_origins as j_affected,
    precompute_neighborhoods as j_precompute,
    refresh_neighborhoods as j_refresh,
)
from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    augment_with_colisten,
)
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    REFRESH_SALT,
    affected_origins,
    precompute_neighborhoods,
    refresh_neighborhoods,
)
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(n_hops=300, t_precompute=20, batch_walkers=256, sweep_blocks=4)
# several blocks and dispatches, short walks: the JAX-uniform replay
SMALL = dict(n_hops=40, t_precompute=12, batch_walkers=32, sweep_blocks=3)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from gcn_song_embeddings_tpu.data import SongGraph as JSongGraph
    from gcn_song_embeddings_tpu.data import make_synthetic_dataset
    from gcn_song_embeddings_tpu.data.device import (
        DeviceGraph as JDeviceGraph,
    )

    ds = make_synthetic_dataset(
        str(tmp_path_factory.mktemp("refresh") / "ds"), n_tracks=600,
        n_collections=150, n_clusters=6, tracks_per_collection=10,
        n_positives=1200, seed=13)
    jdg = JDeviceGraph.from_graph(JSongGraph(ds))
    dg = DeviceGraph.from_graph(SongGraph(ds), "cpu")
    cfg = WalkConfig(**CFG)
    plain_w, plain_n = precompute_neighborhoods(dg, cfg, None, seed=0)
    # cross-cluster pairs: they reshape the walked distributions
    rng = np.random.default_rng(5)
    pairs = np.stack([rng.integers(0, 100, 30),
                      rng.integers(500, 600, 30)], axis=1)
    return dict(ds=ds, dg=dg, aug=augment_with_colisten(dg, pairs, 1),
                jdg=jdg, jaug=j_augment(jdg, pairs, 1), pairs=pairs,
                plain_w=plain_w, plain_n=plain_n, cfg=cfg)


def _tv_rows(w1, n1, w2, n2):
    """Per-row total-variation distance between two top-T weight lists
    (zero-weight slots ignored)."""
    out = np.empty(w1.shape[0])
    for i in range(w1.shape[0]):
        d1 = {int(n): float(v) for n, v in zip(n1[i], w1[i]) if v > 0}
        d2 = {int(n): float(v) for n, v in zip(n2[i], w2[i]) if v > 0}
        out[i] = 0.5 * sum(abs(d1.get(k, 0.0) - d2.get(k, 0.0))
                           for k in set(d1) | set(d2))
    return out


def test_affected_origins_equal_jax(setup):
    s = setup
    for pairs in (s["pairs"], s["pairs"][:3],
                  np.array([[0, 599], [599, 0], [-1, 700], [5, 5]])):
        got = affected_origins(s["plain_w"], s["plain_n"], pairs, 600)
        want = j_affected(s["plain_w"], s["plain_n"], pairs, 600)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    aff = affected_origins(s["plain_w"], s["plain_n"], s["pairs"], 600)
    assert np.isin(np.unique(s["pairs"]), aff).all()
    assert 0 < len(aff) < 600


def test_refresh_matches_full_resweep(setup, tmp_path):
    s = setup
    cfg, aug = s["cfg"], s["aug"]
    path = str(tmp_path / "nb_refresh.npz")
    ref_w, ref_n = refresh_neighborhoods(aug, cfg, s["plain_w"],
                                         s["plain_n"], s["pairs"], path=path,
                                         seed=0)
    aff = affected_origins(s["plain_w"], s["plain_n"], s["pairs"], 600)
    unaff = np.setdiff1d(np.arange(600), aff)
    np.testing.assert_array_equal(ref_w[unaff], s["plain_w"][unaff])
    np.testing.assert_array_equal(ref_n[unaff], s["plain_n"][unaff])

    full1_w, full1_n = precompute_neighborhoods(aug, cfg, None, seed=1)
    full2_w, full2_n = precompute_neighborhoods(aug, cfg, None, seed=2)
    tv_refresh = _tv_rows(ref_w[aff], ref_n[aff],
                          full1_w[aff], full1_n[aff]).mean()
    tv_seed = _tv_rows(full2_w[aff], full2_n[aff],
                       full1_w[aff], full1_n[aff]).mean()
    assert tv_refresh < 1.3 * tv_seed + 0.02, (tv_refresh, tv_seed)
    tv_stale = _tv_rows(s["plain_w"][aff], s["plain_n"][aff],
                        full1_w[aff], full1_n[aff]).mean()
    assert tv_refresh < tv_stale, (tv_refresh, tv_stale)

    cached_w, cached_n = precompute_neighborhoods(aug, cfg, path, seed=0)
    np.testing.assert_array_equal(cached_w, ref_w)
    np.testing.assert_array_equal(cached_n, ref_n)


def test_jax_swept_artifact_refreshed_by_the_port_serves_both(setup,
                                                              tmp_path):
    """JAX sweeps the plain graph, the port refreshes that artifact on the
    augmented graph, and each package's precompute on the augmented graph
    serves the port's file unchanged."""
    s = setup
    jcfg = JWalkConfig(**CFG)
    jw, jn = j_precompute(s["jdg"], jcfg, None, seed=0)
    path = str(tmp_path / "nb.npz")
    ref_w, ref_n = refresh_neighborhoods(s["aug"], s["cfg"], jw, jn,
                                         s["pairs"], path=path, seed=3)
    aff = affected_origins(jw, jn, s["pairs"], 600)
    unaff = np.setdiff1d(np.arange(600), aff)
    np.testing.assert_array_equal(ref_n[unaff], jn[unaff])
    assert s["jaug"].n_edges == s["aug"].n_edges
    for got_w, got_n in (j_precompute(s["jaug"], jcfg, path, seed=0),
                         precompute_neighborhoods(s["aug"], s["cfg"], path,
                                                  seed=0)):
        np.testing.assert_array_equal(np.asarray(got_w), ref_w)
        np.testing.assert_array_equal(np.asarray(got_n), ref_n)


def test_refresh_fed_jax_uniforms_equals_jax(setup, tmp_path):
    """JAX's refresh walks dispatch ``start`` (a multiple of batch *
    n_blocks) block i under fold_in(fold_in(fold_in(key(seed), salt),
    start), i); fed those uniforms block by block, the port's refresh
    gives JAX's artifact exactly (the padded last block included)."""
    s = setup
    seed = 4
    cfg, jcfg = WalkConfig(**SMALL), JWalkConfig(**SMALL)
    old_w, old_n = j_precompute(s["jdg"], jcfg, None, seed=0)
    want = j_refresh(s["jaug"], jcfg, old_w, old_n, s["pairs"], seed=seed)
    n_aff = len(affected_origins(old_w, old_n, s["pairs"], 600))
    bs = cfg.batch_walkers
    n_blocks = max(min(cfg.sweep_blocks, -(-n_aff // bs)), 1)
    assert n_aff > bs * n_blocks   # more than one dispatch

    def jax_uniforms(start, n_walkers):
        first = start - start % (bs * n_blocks)
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), REFRESH_SALT), first)
        key = jax.random.fold_in(key, (start - first) // bs)
        return torch.from_numpy(np.array(jax.random.uniform(
            key, (cfg.n_hops, n_walkers, 3))))

    path = str(tmp_path / "nb.npz")
    got = refresh_neighborhoods(s["aug"], cfg, old_w, old_n, s["pairs"],
                                path=path, seed=seed, uniforms=jax_uniforms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    with np.load(path) as z:
        np.testing.assert_array_equal(z["nodes"], got[1])


def test_refresh_rejects_stale_shape(setup):
    s = setup
    for w, n in ((s["plain_w"][:-1], s["plain_n"][:-1]),
                 (s["plain_w"][:, :-1], s["plain_n"][:, :-1]),
                 (s["plain_w"], s["plain_n"][:, :-1])):
        with pytest.raises(ValueError, match="shape"):
            refresh_neighborhoods(s["aug"], s["cfg"], w, n, s["pairs"])


def test_refresh_with_nothing_affected_keeps_and_saves(setup, tmp_path):
    s = setup
    path = str(tmp_path / "nb.npz")
    w, n = refresh_neighborhoods(s["dg"], s["cfg"], s["plain_w"],
                                 s["plain_n"], np.zeros((0, 2), np.int64),
                                 path=path)
    np.testing.assert_array_equal(w, s["plain_w"])
    np.testing.assert_array_equal(n, s["plain_n"])
    assert os.path.isfile(path)


def test_hybrid_add_refusal_names_a_port_function():
    """``HybridIndex.add_tracks`` refers its caller to
    ``ops.ppr.refresh_neighborhoods``; that name resolves in the port."""
    from gcn_song_embeddings_tpu_torch import serve
    from gcn_song_embeddings_tpu_torch.ops import ppr

    index = serve.HybridIndex.__new__(serve.HybridIndex)
    with pytest.raises(NotImplementedError) as err:
        index.add_tracks(np.zeros((1, 4), np.float32))
    name = "ops.ppr.refresh_neighborhoods"
    assert name in str(err.value)
    assert callable(getattr(ppr, name.rsplit(".", 1)[1]))
