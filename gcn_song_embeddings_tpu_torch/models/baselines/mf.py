"""Implicit-feedback matrix factorization: ALS, BPR and LMF, and the
TrackTrackCF / ColTrackCF recommenders (own copy of
gcn_song_embeddings_tpu/models/baselines/mf.py), in plain PyTorch on a
device (default: the GPU).

  * ALS (Hu-Koren-Volinsky): each half step solves one [F, F] system per
    row.  Rows are padded to a common nnz (``_pad_rows``), and the Gram
    corrections, right-hand sides and batched Cholesky solves run in true
    f32 (TF32 off, ``ops.knn.exact_f32``): Cholesky magnifies the
    rounding of A as the confidences grow.  The initial factors come from
    ``np.random.default_rng(seed)``, as in the JAX package.
  * BPR and LMF: minibatch SGD / AdaGrad steps.  The scatter-adds sum
    duplicate ids, as ``.at[ids].add`` does in JAX, through
    ``index_add_`` (``X[ids] += g`` would keep one of them).  The initial
    factors (``init_factors``) and each iteration's draws (``draws``) are
    methods, so the JAX package's can be fed in.

The recommenders rank items by the cosine of their item factors.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from gcn_song_embeddings_tpu_torch.data.graph import (
    col_track_matrix,
    track_track_matrix,
)
from gcn_song_embeddings_tpu_torch.models.baselines.base import (
    PredictionModel,
)
from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32, knn_from_emb
from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


# ----------------------------------------------------------------- ALS core


def _pad_rows(mat: sp.csr_matrix, max_nnz: int | None = None,
              cap_percentile: float = 99.5
              ) -> tuple[np.ndarray, np.ndarray]:
    """CSR rows -> (indices [R, M] int32, values [R, M] f32), zero-padded.

    M defaults to the ``cap_percentile`` of the row nnz, not the max, so
    one hub row does not blow the block up; rows longer than M keep
    their highest-value entries."""
    nnz = np.diff(mat.indptr)
    rows = mat.shape[0]
    if max_nnz is not None:
        m = int(max_nnz)
    elif nnz.size == 0:
        m = 1
    else:
        m = int(max(min(int(nnz.max()),
                        int(np.percentile(nnz, cap_percentile))), 1))
    idx = np.zeros((rows, m), dtype=np.int32)
    val = np.zeros((rows, m), dtype=np.float32)
    take = np.minimum(nnz, m)

    # truncated (hub) rows: move their top-value entries to the front of
    # their slices first
    indices = mat.indices
    data = mat.data
    over = np.nonzero(nnz > m)[0]
    if over.size:
        indices = indices.copy()
        data = data.copy()
        for r in over:
            s, e = mat.indptr[r], mat.indptr[r + 1]
            top = np.argpartition(-data[s:e], m - 1)[:m]
            indices[s:s + m] = indices[s:e][top]
            data[s:s + m] = data[s:e][top]

    row_ids = np.repeat(np.arange(rows), take)
    col_pos = (np.arange(take.sum(), dtype=np.int64)
               - np.repeat(np.cumsum(take) - take, take))
    src = np.repeat(mat.indptr[:-1], take) + col_pos
    idx[row_ids, col_pos] = indices[src]
    val[row_ids, col_pos] = data[src]
    return idx, val


def _als_solve_block(Y: torch.Tensor, YtY: torch.Tensor, idx: torch.Tensor,
                     conf: torch.Tensor, reg: float) -> torch.Tensor:
    """Solve (YtY + Y_u^T (C_u - I) Y_u + reg I) x = Y_u^T C_u p_u for a
    block of rows: idx / conf [B, M] padded item ids / confidences
    (1 + alpha * r; padding has confidence 0 and is masked)."""
    F = Y.shape[1]
    Yu = Y[idx.long()]                            # [B, M, F]
    mask = (conf > 0).to(torch.float32)
    cprime = (conf - 1.0) * mask                  # (c - 1), 0 on padding
    with exact_f32():
        A = YtY[None] + torch.bmm((Yu * cprime[..., None]).transpose(1, 2),
                                  Yu)
        b = torch.bmm((conf * mask)[:, None, :], Yu)[:, 0]
    A = A + reg * torch.eye(F, dtype=torch.float32, device=Y.device)[None]
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _als_half_step(X: torch.Tensor, Y: torch.Tensor, idx: torch.Tensor,
                   conf: torch.Tensor, reg: float, block: int = 2048
                   ) -> torch.Tensor:
    """Every row of X solved against the fixed Y, ``block`` rows a
    solve."""
    with exact_f32():
        YtY = Y.t() @ Y
    out = torch.empty_like(X)
    for s in range(0, X.shape[0], block):
        out[s:s + block] = _als_solve_block(Y, YtY, idx[s:s + block],
                                            conf[s:s + block], reg)
    return out


class ALS:
    """Implicit-feedback ALS (implicit.cpu.als's algorithm): factors 128,
    regularization 0.01, 15 iterations, alpha 1, on ``device``."""

    def __init__(self, factors: int = 128, regularization: float = 0.01,
                 iterations: int = 15, alpha: float = 1.0, seed: int = 0,
                 device=None):
        self.factors = factors
        self.reg = regularization
        self.iterations = iterations
        self.alpha = alpha
        self.seed = seed
        self.device = device

    def fit(self, mat: sp.csr_matrix) -> None:
        """mat: [users, items] implicit ratings."""
        dev = resolve_device(self.device)
        users, items = mat.shape
        rng = np.random.default_rng(self.seed)
        # implicit's init: rand * 0.01
        X = (rng.random((users, self.factors)) * 0.01).astype(np.float32)
        Y = (rng.random((items, self.factors)) * 0.01).astype(np.float32)
        X, Y = (torch.as_tensor(a, device=dev) for a in (X, Y))

        sides = []
        for m in (mat.tocsr(), mat.T.tocsr()):
            idx, val = _pad_rows(m)
            conf = np.where(val > 0, 1.0 + self.alpha * val, 0.0)
            sides.append((torch.as_tensor(idx, device=dev),
                          torch.as_tensor(conf.astype(np.float32),
                                          device=dev)))
        (u_idx, u_conf), (i_idx, i_conf) = sides
        for _ in range(self.iterations):
            X = _als_half_step(X, Y, u_idx, u_conf, self.reg)
            Y = _als_half_step(Y, X, i_idx, i_conf, self.reg)
        self.user_factors = X.cpu().numpy()
        self.item_factors = Y.cpu().numpy()


# --------------------------------------------------------- BPR / LMF cores


class _SGDFactors:
    """Shared frame of BPR and LMF: the positives of ``mat`` as (user,
    item, value) tensors, ``iterations`` passes of max(n_pos // batch, 1)
    steps, each iteration's draws from ``draws``."""

    def __init__(self, factors: int, learning_rate: float,
                 regularization: float, iterations: int, seed: int,
                 batch: int, device=None):
        self.factors = factors
        self.lr = learning_rate
        self.reg = regularization
        self.iterations = iterations
        self.seed = seed
        self.batch = batch
        self.device = device

    def init_factors(self, users: int, items: int, dev
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The initial (user [users, F], item [items, F]) factors."""
        raise NotImplementedError

    def draws(self, iteration: int, steps: int, n_pos: int, items: int,
              dev) -> tuple[torch.Tensor, torch.Tensor]:
        """Iteration ``iteration``'s draws: (rows [steps, batch] into the
        positives, item ids [steps, n] of the sampled negatives)."""
        raise NotImplementedError

    def fit(self, mat: sp.csr_matrix) -> None:
        dev = resolve_device(self.device)
        users, items = mat.shape
        coo = mat.tocoo()
        pos_u = torch.as_tensor(coo.row.astype(np.int64), device=dev)
        pos_i = torch.as_tensor(coo.col.astype(np.int64), device=dev)
        vals = torch.as_tensor(coo.data.astype(np.float32), device=dev)
        n_pos = pos_u.shape[0]
        # the stream the default init_factors and draws read
        self._gen = seeded_generator([self.seed], dev)
        X, Y = self.init_factors(users, items, dev)
        state = self.start(X, Y)
        steps = max(n_pos // self.batch, 1)
        for it in range(self.iterations):
            rows, neg = self.draws(it, steps, n_pos, items, dev)
            for s in range(steps):
                r = rows[s].long()
                self.step(state, pos_u[r], pos_i[r], vals[r], neg[s].long())
        self.user_factors = state[0].cpu().numpy()
        self.item_factors = state[1].cpu().numpy()

    def start(self, X, Y) -> list:
        """The state ``step`` updates in place: the factors (and any
        optimizer state after them)."""
        return [X, Y]


class BPR(_SGDFactors):
    """Bayesian Personalized Ranking (implicit.cpu.bpr's update): SGD on
    -log sigmoid(x_u . (y_i - y_j)) with L2 regularization; lr 0.01, reg
    0.01, 100 iterations of |R| / batch steps."""

    def __init__(self, factors: int = 128, learning_rate: float = 0.01,
                 regularization: float = 0.01, iterations: int = 100,
                 seed: int = 0, batch: int = 4096, device=None):
        super().__init__(factors, learning_rate, regularization, iterations,
                         seed, batch, device)

    def init_factors(self, users, items, dev):
        # implicit's init: normal / factors
        return tuple(torch.randn((n, self.factors), generator=self._gen,
                                 device=dev) / self.factors
                     for n in (users, items))

    def draws(self, iteration, steps, n_pos, items, dev):
        rows = torch.randint(0, n_pos, (steps, self.batch),
                             generator=self._gen, device=dev)
        j = torch.randint(0, items, (steps, self.batch),
                          generator=self._gen, device=dev)
        return rows, j

    def step(self, state, u, i, r, j) -> None:
        X, Y = state
        lr, reg = self.lr, self.reg
        xu, yi, yj = X[u], Y[i], Y[j]
        score = torch.sum(xu * (yi - yj), dim=1)
        z = (1.0 / (1.0 + torch.exp(score)))[:, None]   # dL/dscore
        gu = z * (yi - yj) - reg * xu
        gi = z * xu - reg * yi
        gj = -z * xu - reg * yj
        X.index_add_(0, u, lr * gu)
        Y.index_add_(0, i, lr * gi)
        Y.index_add_(0, j, lr * gj)


class LMF(_SGDFactors):
    """Logistic matrix factorization (implicit.cpu.lmf's loss): AdaGrad
    ascent on the logistic likelihood, ``2 * batch`` sampled negatives a
    step weighted 1 / neg_prop; lr 0.3, reg 0.05, 100 iterations (the JAX
    package's tuned defaults)."""

    def __init__(self, factors: int = 128, learning_rate: float = 0.3,
                 regularization: float = 0.05, iterations: int = 100,
                 neg_prop: int = 5, seed: int = 0, batch: int = 4096,
                 device=None):
        super().__init__(factors, learning_rate, regularization, iterations,
                         seed, batch, device)
        self.neg_prop = neg_prop

    def init_factors(self, users, items, dev):
        return tuple(torch.randn((n, self.factors), generator=self._gen,
                                 device=dev) * 0.01
                     for n in (users, items))

    def draws(self, iteration, steps, n_pos, items, dev):
        rows = torch.randint(0, n_pos, (steps, self.batch),
                             generator=self._gen, device=dev)
        jneg = torch.randint(0, items, (steps, 2 * self.batch),
                             generator=self._gen, device=dev)
        return rows, jneg

    def start(self, X, Y) -> list:
        return [X, Y, torch.ones_like(X), torch.ones_like(Y)]  # + AdaGrad

    def step(self, state, u, i, r, jneg) -> None:
        X, Y, GX, GY = state
        reg = self.reg
        # positive part: the gradient of r*s - (1+r)*log(1+e^s)
        xu, yi = X[u], Y[i]
        s = torch.sum(xu * yi, dim=1)
        gpos = (r - (1.0 + r) * torch.sigmoid(s))[:, None]
        gu = gpos * yi - reg * xu
        gi = gpos * xu - reg * yi
        # sampled negatives: r = 0, gradient -sigmoid(s)
        un = u.repeat(2)
        xun, yjn = X[un], Y[jneg]
        sn = torch.sum(xun * yjn, dim=1)
        gneg = (-torch.sigmoid(sn))[:, None] / self.neg_prop
        gun = gneg * yjn
        gjn = gneg * xun
        for P, G, ids, g in ((X, GX, u, gu), (Y, GY, i, gi),
                             (X, GX, un, gun), (Y, GY, jneg, gjn)):
            self.adagrad(P, G, ids, g)

    def adagrad(self, P, G, ids, g) -> None:
        """Add the whole batch's g*g to G first, then step each row by
        lr * g / sqrt(G[ids]) read after it."""
        G.index_add_(0, ids, g * g)
        P.index_add_(0, ids, self.lr * g / torch.sqrt(G[ids]))


# ------------------------------------------------------------- recommenders


def _make_model(algo: str, factors: int, device):
    if algo == "als":
        return ALS(factors=factors, device=device)
    if algo == "lmf":
        return LMF(factors=factors, device=device)
    return BPR(factors=factors, device=device)


class TrackTrackCF(PredictionModel):
    """MF of the track-track co-occurrence matrix of the train
    positives."""

    def __init__(self, algo: str = "als", factors: int = 128, device=None):
        self.algo = algo
        self.factors = factors
        self.device = device

    def train(self, graph, ids, train_set, test_set, features) -> None:
        self._fit(track_track_matrix(len(ids), np.asarray(train_set)))

    def _fit(self, mat: sp.csr_matrix) -> None:
        self.model = _make_model(self.algo, self.factors, self.device)
        self.model.fit(mat.astype(np.float32))
        self._table = torch.as_tensor(self.model.item_factors,
                                      device=resolve_device(self.device))

    def knn(self, nodeset, k):
        return knn_from_emb(self._table, np.asarray(nodeset), k)


class ColTrackCF(TrackTrackCF):
    """MF of the playlist-track membership matrix."""

    def train(self, graph, ids, train_set, test_set, features) -> None:
        self._fit(col_track_matrix(graph))
