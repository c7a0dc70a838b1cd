"""The port's matrix factorization (``models/baselines/mf.py``: ``_pad_rows``,
the ALS solves, ``ALS``, ``BPR``, ``LMF``, ``TrackTrackCF``,
``ColTrackCF``) vs the JAX package, on the CPU.

Tolerances: ``_pad_rows`` is the same numpy, so equal bit for bit; the ALS
block solve and half step within 1e-4 relative of the float64 dense oracle
(the bar of tests/test_mf_oracle.py); ``ALS.fit`` from the same numpy init
within the same bar of JAX's factors (the largest difference at most 1e-4
of the largest factor: f32 Cholesky solves in another order, iterated;
entries near 0 carry no relative precision); BPR and LMF fed JAX's initial
factors and draws within rtol 1e-5 / atol 1e-7 (f32 scatter-adds of
duplicate ids summed in another order); the scatter-adds on a batch of
duplicate ids within 1e-6 of a float64 reference.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gcn_song_embeddings_tpu.models.baselines.mf import (
    ALS as JALS,
    BPR as JBPR,
    LMF as JLMF,
    _pad_rows as j_pad_rows,
)
from gcn_song_embeddings_tpu_torch.data.graph import (
    SongGraph,
    col_track_matrix,
)
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.models.baselines import (
    ColTrackCF,
    TrackTrackCF,
)
from gcn_song_embeddings_tpu_torch.models.baselines.mf import (
    ALS,
    BPR,
    LMF,
    _als_half_step,
    _als_solve_block,
    _pad_rows,
)
from torch_threads import one_torch_thread  # noqa: F401


def _dense_oracle_row(Y64, item_ids, ratings, reg, alpha=1.0):
    """One user's exact float64 normal-equation solve over every item."""
    n_items, F = Y64.shape
    c = np.ones(n_items)
    p = np.zeros(n_items)
    c[item_ids] = 1.0 + alpha * ratings
    p[item_ids] = 1.0
    A = Y64.T @ (c[:, None] * Y64) + reg * np.eye(F)
    return np.linalg.solve(A, Y64.T @ (c * p))


def _rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _random_csr(rng, rows, cols, density, hub_row=None):
    dense = (rng.random((rows, cols)) < density) * rng.uniform(
        0.5, 4.0, (rows, cols))
    if hub_row is not None:
        dense[hub_row] = rng.permutation(np.arange(1.0, cols + 1.0))
    return sp.csr_matrix(dense.astype(np.float32))


@pytest.mark.parametrize("max_nnz", [None, 3, 8, 1])
def test_pad_rows_equal_jax(max_nnz):
    rng = np.random.default_rng(0)
    for mat in (_random_csr(rng, 40, 200, 0.025, hub_row=39),
                _random_csr(rng, 30, 12, 0.4),
                sp.csr_matrix((5, 7), dtype=np.float32)):
        got = _pad_rows(mat, max_nnz=max_nnz)
        want = j_pad_rows(mat, max_nnz=max_nnz)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_als_solve_block_matches_f64_oracle():
    rng = np.random.default_rng(0)
    n_items, F, B, M_, reg, alpha = 60, 16, 8, 12, 0.01, 1.0
    Y = rng.normal(0, 0.3, (n_items, F)).astype(np.float32)
    idx = np.zeros((B, M_), np.int32)
    conf = np.zeros((B, M_), np.float32)
    expected = np.zeros((B, F))
    for u in range(B):
        nnz = int(rng.integers(1, M_ + 1))        # padding exercised
        items = rng.choice(n_items, nnz, replace=False)
        r = rng.uniform(0.5, 5.0, nnz)
        idx[u, :nnz] = items
        conf[u, :nnz] = 1.0 + alpha * r
        expected[u] = _dense_oracle_row(Y.astype(np.float64), items, r, reg,
                                        alpha)
    Yt = torch.from_numpy(Y)
    got = _als_solve_block(Yt, Yt.t() @ Yt, torch.from_numpy(idx),
                           torch.from_numpy(conf), reg).numpy()
    assert _rel_err(got, expected) <= 1e-4


def test_als_half_step_matches_f64_oracle_through_pad_rows():
    rng = np.random.default_rng(1)
    users, items, F, reg, alpha = 50, 40, 8, 0.05, 1.0
    mat = _random_csr(rng, users, items, 0.15)
    Y = rng.normal(0, 0.3, (items, F)).astype(np.float32)
    idx, val = _pad_rows(mat, max_nnz=int(np.diff(mat.indptr).max()))
    conf = np.where(val > 0, 1.0 + alpha * val, 0.0).astype(np.float32)
    got = _als_half_step(torch.zeros((users, F)), torch.from_numpy(Y),
                         torch.from_numpy(idx), torch.from_numpy(conf), reg,
                         block=16).numpy()
    expected = np.stack([
        _dense_oracle_row(Y.astype(np.float64), mat[u].indices,
                          mat[u].data, reg, alpha) for u in range(users)])
    assert _rel_err(got, expected) <= 1e-4


@pytest.fixture(scope="module")
def port_graph(dataset_dir):
    return SongGraph(dataset_dir)


@pytest.mark.parametrize("source", ["col_track", "random"])
def test_als_fit_equals_jax(port_graph, source):
    if source == "col_track":
        mat = col_track_matrix(port_graph).astype(np.float32)
    else:
        mat = _random_csr(np.random.default_rng(2), 70, 45, 0.12)
    got = ALS(factors=16, iterations=3, seed=5, device="cpu")
    want = JALS(factors=16, iterations=3, seed=5)
    got.fit(mat)
    want.fit(mat)
    for g, w in ((got.user_factors, want.user_factors),
                 (got.item_factors, want.item_factors)):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= 1e-4


def _jax_sgd_draws(kind, seed, users, items, F, n_pos, batch, iterations):
    """The JAX package's initial factors and per-iteration draws of BPR /
    LMF.fit, from its own key schedule."""
    key = jax.random.PRNGKey(seed)
    if kind == "bpr":
        k_init, key = jax.random.split(key)
        X = jax.random.normal(k_init, (users, F)) / F
        k_init2, key = jax.random.split(key)
        Y = jax.random.normal(k_init2, (items, F)) / F
        n_neg = batch
    else:
        kx, ky, key = jax.random.split(key, 3)
        X = jax.random.normal(kx, (users, F)) * 0.01
        Y = jax.random.normal(ky, (items, F)) * 0.01
        n_neg = 2 * batch
    steps = max(n_pos // batch, 1)
    draws = []
    for _ in range(iterations):
        key, ekey = jax.random.split(key)
        rows, neg = [], []
        for skey in jax.random.split(ekey, steps):
            ks, kn = jax.random.split(skey)
            rows.append(np.asarray(jax.random.randint(ks, (batch,), 0,
                                                      n_pos)))
            neg.append(np.asarray(jax.random.randint(kn, (n_neg,), 0,
                                                     items)))
        draws.append((torch.from_numpy(np.stack(rows)),
                      torch.from_numpy(np.stack(neg))))
    return (torch.from_numpy(np.array(X)), torch.from_numpy(np.array(Y)),
            draws)


@pytest.mark.parametrize("kind", ["bpr", "lmf"])
def test_sgd_steps_fed_jax_draws_equal_jax(kind):
    """A few iterations on a small matrix, batches full of duplicate user,
    item and negative ids, from JAX's init and draws."""
    rng = np.random.default_rng(3)
    mat = _random_csr(rng, 20, 15, 0.3)
    F, batch, iters, seed = 8, 32, 3, 7
    n_pos = mat.nnz
    X, Y, draws = _jax_sgd_draws(kind, seed, 20, 15, F, n_pos, batch, iters)
    assert len(draws[0][0]) == n_pos // batch >= 2
    coo = mat.tocoo()
    users_in_batch = coo.row[draws[0][0][0].numpy()]
    assert len(np.unique(users_in_batch)) < batch      # duplicates
    jax_cls, port_cls = (JBPR, BPR) if kind == "bpr" else (JLMF, LMF)
    want = jax_cls(factors=F, iterations=iters, seed=seed, batch=batch)
    want.fit(mat)
    got = port_cls(factors=F, iterations=iters, seed=seed, batch=batch,
                   device="cpu")
    got.init_factors = lambda users, items, dev: (X.clone(), Y.clone())
    got.draws = lambda it, steps, n_pos, items, dev: draws[it]
    got.fit(mat)
    for g, w in ((got.user_factors, want.user_factors),
                 (got.item_factors, want.item_factors)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)


def _f64_bpr_step(X, Y, u, i, j, lr, reg):
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    xu, yi, yj = X[u], Y[i], Y[j]
    z = 1.0 / (1.0 + np.exp(np.sum(xu * (yi - yj), axis=1)))[:, None]
    np.add.at(X, u, lr * (z * (yi - yj) - reg * xu))
    np.add.at(Y, i, lr * (z * xu - reg * yi))
    np.add.at(Y, j, lr * (-z * xu - reg * yj))
    return X, Y


def _f64_lmf_step(X, Y, GX, GY, u, i, r, jneg, lr, reg, neg_prop):
    X, Y, GX, GY = (a.astype(np.float64) for a in (X, Y, GX, GY))
    s = np.sum(X[u] * Y[i], axis=1)
    gpos = (r - (1.0 + r) / (1.0 + np.exp(-s)))[:, None]
    gu, gi = gpos * Y[i] - reg * X[u], gpos * X[u] - reg * Y[i]
    un = np.tile(u, 2)
    sn = np.sum(X[un] * Y[jneg], axis=1)
    gneg = -(1.0 / (1.0 + np.exp(-sn)))[:, None] / neg_prop
    gun, gjn = gneg * Y[jneg], gneg * X[un]
    for P, G, ids, g in ((X, GX, u, gu), (Y, GY, i, gi), (X, GX, un, gun),
                         (Y, GY, jneg, gjn)):
        np.add.at(G, ids, g * g)
        np.add.at(P, ids, lr * g / np.sqrt(G[ids]))
    return X, Y


def test_scatter_adds_of_duplicate_ids_equal_float64():
    """Every id of the batch repeated: ``index_add_`` must sum them all,
    as JAX's ``.at[ids].add`` does."""
    rng = np.random.default_rng(4)
    X = rng.normal(0, 0.3, (6, 8)).astype(np.float32)
    Y = rng.normal(0, 0.3, (5, 8)).astype(np.float32)
    u = np.array([0, 0, 0, 1, 1, 5, 0, 1])
    i = np.array([2, 2, 3, 2, 4, 4, 2, 2])
    j = np.array([1, 1, 1, 0, 0, 3, 2, 2])
    r = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    jneg = np.concatenate([j, j[::-1]])

    bpr = BPR(factors=8, learning_rate=0.3, device="cpu")
    state = [torch.from_numpy(X.copy()), torch.from_numpy(Y.copy())]
    bpr.step(state, *(torch.from_numpy(a) for a in (u, i, r, j)))
    for g, w in zip(state, _f64_bpr_step(X, Y, u, i, j, 0.3, bpr.reg)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)

    lmf = LMF(factors=8, device="cpu")
    state = lmf.start(torch.from_numpy(X.copy()), torch.from_numpy(Y.copy()))
    lmf.step(state, *(torch.from_numpy(a) for a in (u, i, r, jneg)))
    want = _f64_lmf_step(X, Y, np.ones_like(X), np.ones_like(Y), u, i, r,
                         jneg, lmf.lr, lmf.reg, lmf.neg_prop)
    for g, w in zip(state[:2], want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)
    # X[ids] += g keeps one of the duplicates: the sum really differs
    kept = torch.from_numpy(X.copy())
    kept[torch.from_numpy(u)] += 1.0
    assert not np.allclose(kept.numpy(), X + np.bincount(u, minlength=6)
                           [:, None])


@pytest.mark.parametrize("algo", ["als", "bpr", "lmf"])
def test_cf_learns_structure(port_graph, positives, algo):
    """ColTrackCF on the clustered graph ranks held-out positives well
    above chance (~0.2 at hit@100 over 500 tracks)."""
    m = ColTrackCF(algo=algo, factors=32, device="cpu")
    m.train(port_graph, port_graph.track_ids, positives[:1200], None, None)
    _, n = m.knn(np.arange(port_graph.n_items), 100)
    assert M.hit_rate(n, positives[1200:], 100) > 0.35


def test_tracktrack_cf_smoke(port_graph, positives):
    m = TrackTrackCF(algo="als", factors=16, device="cpu")
    m.train(port_graph, port_graph.track_ids, positives[:1000], None, None)
    w, n = m.knn(np.arange(10), 5)
    assert n.shape == (10, 5) and np.isfinite(w).all()
    assert m.model.item_factors.shape == (port_graph.n_items, 16)
