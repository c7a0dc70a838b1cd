"""The eval rows' plain-PyTorch paths on the card against the CPU's: ALS,
node2vec walks, the BPR / LMF scatter-adds of duplicate ids, and the
refresh's re-sweep through kernel K1.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_baselines_gpu.py

Tolerances: ALS factors within 1e-4 of the largest factor (f32 Cholesky
on two back ends); walks equal exactly (integer gathers and f32 compares
under the same draws); scatter-adds of duplicate ids agree with each
other and with a float64 reference within the rounding of their f32
additions (the most repeated id's count x 2^-24 x the largest entry;
atomic adds sum duplicates in another order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    augment_with_colisten,
)
from gcn_song_embeddings_tpu_torch.models.baselines.mf import ALS, BPR, LMF
from gcn_song_embeddings_tpu_torch.ops import walk_kernel
from gcn_song_embeddings_tpu_torch.ops.node2vec import (
    build_alias_graph,
    draw_walks,
    node2vec_walks,
)
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    affected_origins,
    precompute_neighborhoods,
    refresh_neighborhoods,
    seeded_generator,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (these compare the card with the "
                    "CPU)")
    return torch.device("cuda")


def _rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def test_als_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(0)
    dense = (rng.random((300, 200)) < 0.05) * rng.uniform(0.5, 3.0,
                                                            (300, 200))
    mat = sp.csr_matrix(dense.astype(np.float32))
    fits = []
    for dev in (cuda, "cpu"):
        m = ALS(factors=32, iterations=4, seed=1, device=dev)
        m.fit(mat)
        fits.append(m)
    assert _rel_err(fits[0].user_factors, fits[1].user_factors) <= 1e-4
    assert _rel_err(fits[0].item_factors, fits[1].item_factors) <= 1e-4


def _csr(n=400, deg=12, seed=0):
    rng = np.random.default_rng(seed)
    rows = [np.unique(rng.integers(0, n, deg)) for _ in range(n)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    weights = rng.integers(1, 4, indptr[-1]).astype(np.float64)
    return indptr, np.concatenate(rows), weights


def test_node2vec_walks_on_the_card_equal_the_cpu(cuda):
    indptr, indices, weights = _csr()
    draws = draw_walks(512, 20, 3, seeded_generator([2], "cpu"))
    starts = torch.arange(512) % 400
    walks = []
    for dev in (cuda, torch.device("cpu")):
        g = build_alias_graph(indptr, indices, weights, device=dev)
        walks.append(node2vec_walks(g, starts.to(dev), 20, 2.0, 0.5,
                                    type(draws)(*(t.to(dev)
                                                  for t in draws))).cpu())
    assert torch.equal(walks[0], walks[1])
    for row in walks[0].numpy()[:64]:
        for u, v in zip(row[:-1], row[1:]):
            assert v in indices[indptr[u]:indptr[u + 1]]


def _sum_tol(ids, ref):
    """The rounding of f32 additions of duplicate ids: each add of the
    most repeated id rounds at most half an ulp of the largest entry."""
    dups = max(np.bincount(a).max() for a in ids)
    return dups * 2.0 ** -24 * float(np.abs(ref).max())


def test_scatter_adds_of_duplicate_ids_on_the_card(cuda):
    rng = np.random.default_rng(3)
    X = rng.normal(0, 0.3, (50, 16)).astype(np.float32)
    Y = rng.normal(0, 0.3, (40, 16)).astype(np.float32)
    u = rng.integers(0, 5, 4096)          # every id repeated ~800 times
    i = rng.integers(0, 4, 4096)
    j = rng.integers(0, 6, 8192)
    r = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    for model, neg in ((BPR(factors=16, learning_rate=1e-4), j[:4096]),
                       (LMF(factors=16, learning_rate=1e-3), j)):
        out = []
        for dev in (cuda, torch.device("cpu")):
            state = model.start(torch.tensor(X, device=dev),
                                torch.tensor(Y, device=dev))
            model.step(state, *(torch.as_tensor(a, device=dev)
                                for a in (u, i, r, neg)))
            out.append([t.cpu().numpy() for t in state])
        for card, cpu in zip(out[0], out[1]):
            np.testing.assert_allclose(card, cpu, atol=_sum_tol(
                (u, i, neg), cpu))
        if isinstance(model, BPR):
            X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
            diff = Y64[i] - Y64[neg]
            z = 1.0 / (1.0 + np.exp(np.sum(X64[u] * diff, 1)))
            want = X64.copy()
            np.add.at(want, u, model.lr * (z[:, None] * diff
                                           - model.reg * X64[u]))
            np.testing.assert_allclose(out[0][0], want,
                                       atol=_sum_tol((u, i, neg), want))


def test_refresh_on_the_card_launches_k1_and_keeps_unaffected_rows(cuda):
    rng = np.random.default_rng(4)
    n_items, n_cols = 2000, 400
    cols = [np.unique(rng.integers(0, n_cols, 3)) for _ in range(n_items)]
    i2c_indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    src = np.repeat(np.arange(n_items), [len(c) for c in cols])
    dst = np.concatenate(cols)
    order = np.lexsort((src, dst))
    c2i_indptr = np.concatenate([[0], np.cumsum(np.bincount(
        dst, minlength=n_cols))])
    dg = DeviceGraph.from_arrays(i2c_indptr, dst, c2i_indptr, src[order],
                                 cuda)
    cfg = WalkConfig(n_hops=100, t_precompute=20, batch_walkers=256)
    old_w, old_n = precompute_neighborhoods(dg, cfg, None, seed=0)
    pairs = np.stack([rng.integers(0, 50, 10),
                      rng.integers(1950, 2000, 10)], axis=1)
    aug = augment_with_colisten(dg, pairs, 1)
    before = walk_kernel.launches
    new_w, new_n = refresh_neighborhoods(aug, cfg, old_w, old_n, pairs)
    aff = affected_origins(old_w, old_n, pairs, n_items)
    assert walk_kernel.launches - before == -(-len(aff) // 256)
    keep = np.setdiff1d(np.arange(n_items), aff)
    np.testing.assert_array_equal(new_w[keep], old_w[keep])
    np.testing.assert_array_equal(new_n[keep], old_n[keep])
    assert (new_n[aff] != old_n[aff]).any()
