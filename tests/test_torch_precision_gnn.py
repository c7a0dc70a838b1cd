"""The matmul precision policy's reach into the GNN family
(``models/gnnlib.py``) and node2vec's skip-gram
(``models/baselines/node2vec.py``) against the JAX package at the TPU's
numerics, on the CPU.

The JAX side runs through ``tests/tpu_numerics.py``'s jaxpr evaluator,
which rounds every default-precision f32 product of the JAX function
(the layers' ``@``, the ``einsum``s inside skip-gram's ``lax.scan`` and
the transposed products of a grad) as the TPU does at ``default`` (one
bf16 pass) or ``high`` (three).

Tolerances (tests/test_torch_precision.py's header), relative
(Frobenius): at ``default`` 1e-3 (``REL``), since an f32 intermediate is
rounded again (sage's and gcn's mean, GAT's projections, every grad's
cotangent) and two orders of f32 sums can round an entry to
neighbouring bf16 values, 2^-8 apart; at ``high`` 2e-5, since a flip
there moves only the lo part, by at most 2^-16 of the entry (the f32
function lies ~5e-6 from ``high``'s, so a ``high`` test also checks
that the policy changed the bits).  Skip-gram's trajectory is held on
the change of ``W_in`` (its initial values are the same bits on both
sides), at ``default`` within 1e-4: its rounded operands are the f32
state, whose scatter-adds of duplicate ids the packages sum in another
order, and a flip there moves one product term by 2^-8 of itself, far
below the update (the unrounded run lies 8e-4 from JAX's ``default``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.models import gnnlib as jgnn
from gcn_song_embeddings_tpu.models.baselines import node2vec as jn2v
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
from gcn_song_embeddings_tpu_torch.models import gnnlib
from gcn_song_embeddings_tpu_torch.models.baselines import GraphSAGE
from gcn_song_embeddings_tpu_torch.models.baselines import node2vec
from gcn_song_embeddings_tpu_torch.models.baselines.node2vec import (
    SkipgramDraws,
    skipgram_steps,
    train_skipgram,
)
from gcn_song_embeddings_tpu_torch.ops import agg
from gcn_song_embeddings_tpu_torch.utils import precision
from torch_threads import one_torch_thread  # noqa: F401
from tpu_numerics import tpu_eval

REL = 1e-3
VALUES = {"default": 1, "high": 3}
TOL = {"default": REL, "high": 2e-5}
SKIPGRAM_TOL = {"default": 1e-4, "high": 2e-5}
IN, HID, S, M = 12, 16, 4, 24


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _layer_inputs(layer, seed=0):
    rng = np.random.default_rng(seed)
    p = jgnn.init_gnn_layer(jax.random.PRNGKey(seed), layer, IN, HID)
    return (p, rng.normal(size=(M, IN)).astype(np.float32),
            rng.normal(size=(M, S, IN)).astype(np.float32),
            rng.normal(size=(M, HID)).astype(np.float32))


def _port_layer(p, layer, h_self, h_nb, ct):
    """The port's layer and its gradients (params, h_self, h_nb) against
    the cotangent ``ct``."""
    tp = {k: v.clone().requires_grad_() for k, v in gnnlib.params_from_jax(
        {"l": p}, "cpu")["l"].items()}
    hs = torch.from_numpy(h_self).requires_grad_()
    hn = torch.from_numpy(h_nb).requires_grad_()
    out = gnnlib.gnn_layer_apply(tp, layer, hs, hn)
    grads = torch.autograd.grad(out, [*tp.values(), hs, hn],
                                torch.from_numpy(ct))
    return out.detach().numpy(), dict(zip([*tp, "h_self", "h_nb"],
                                          (g.numpy() for g in grads)))


@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("layer", ["sage", "gcn", "gat"])
def test_layer_and_grads_match_jax_at_tpu_numerics(layer, value):
    """One layer's output and its gradients (W, GAT's attention vectors,
    both inputs) against ``jax.vjp`` of the JAX package's layer run at
    the TPU's numerics: output and each gradient within TOL."""
    p, h_self, h_nb, ct = _layer_inputs(layer)

    def jax_layer(p_, hs, hn, c):
        out, vjp = jax.vjp(lambda a, b, d: jgnn.gnn_layer_apply(
            a, layer, b, d), p_, hs, hn)
        gp, ghs, ghn = vjp(c)
        return out, {**gp, "h_self": ghs, "h_nb": ghn}

    want, want_g = tpu_eval(jax_layer, VALUES[value])(
        p, jnp.asarray(h_self), jnp.asarray(h_nb), jnp.asarray(ct))
    with precision.override(value):
        got, got_g = _port_layer(p, layer, h_self, h_nb, ct)
    assert _rel(got, want) <= TOL[value]
    assert set(got_g) == set(want_g)
    for k, g in got_g.items():
        assert _rel(g, want_g[k]) <= TOL[value], k
    f32, _ = _port_layer(p, layer, h_self, h_nb, ct)
    assert not np.array_equal(got, f32)          # the policy took effect


def _randint(key, shape):
    return torch.from_numpy(np.array(jax.random.randint(
        key, shape, 0, gnnlib.DRAW_RANGE)))


def _jax_unsup_draws(core, key, n_nodes):
    """JAX's draws of one unsupervised step (``GNNCore._unsup_loss`` and
    its ``encode``), from the step's key."""
    B, S_ = core.batch, core.n_sample
    ks, kp, kn, ke = jax.random.split(key, 4)
    ka, kb, kc = jax.random.split(ke, 3)
    m = 3 * B
    return {"nodes": torch.from_numpy(np.array(
                jax.random.randint(ks, (B,), 0, n_nodes))),
            "pos": _randint(kp, (B, 1)),
            "neg": torch.from_numpy(np.array(
                jax.random.randint(kn, (B,), 0, n_nodes))),
            "encode": (_randint(ka, (m, S_)), _randint(kb, (m * S_, S_)),
                       _randint(kc, (m, S_)))}


def _graph(n=60, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, indptr[-1]).astype(np.int32)
    return indptr, indices


@pytest.mark.parametrize("layer", ["sage", "gcn", "gat"])
def test_gnncore_loss_and_grads_match_jax_at_tpu_numerics(layer):
    """One unsupervised ``GNNCore`` loss (two layers, the norm, the
    margin) and its gradients on JAX's draws and parameters, against
    ``jax.value_and_grad`` of the JAX package's loss at ``default``:
    loss within 1e-5 relative, each gradient within REL."""
    indptr, indices = _graph()
    n = len(indptr) - 1
    feats = np.random.default_rng(2).normal(size=(n, IN)).astype(np.float32)
    kw = dict(layer=layer, hidden_dim=HID, out_dim=8, n_sample=S, batch=8,
              seed=4)
    jcore = jgnn.GNNCore(**kw)
    params, _ = jcore._init_params(IN, 8)
    ip, ix = jnp.asarray(indptr), jnp.asarray(indices)
    encode = jcore._make_encode(jnp.asarray(feats), ip, ix)
    key = jax.random.PRNGKey(11)

    def jax_loss(p):
        return jcore._unsup_loss(p, key, encode=encode, ip=ip, ix=ix,
                                 n_nodes=n, batch=kw["batch"],
                                 train_pool=None)

    want_loss, want_g = tpu_eval(jax.value_and_grad(jax_loss), 1)(params)
    core = gnnlib.GNNCore(device="cpu", **kw)
    core._feats = torch.from_numpy(feats)
    core._ip = torch.from_numpy(indptr.astype(np.int64))
    core._ix = torch.from_numpy(indices.astype(np.int64))
    tp = gnnlib.params_from_jax(params, "cpu")
    leaves = [(name, k, t.requires_grad_()) for name, layer_p in tp.items()
              for k, t in layer_p.items()]
    with precision.override("default"):
        loss = core.loss(tp, _jax_unsup_draws(core, key, n))
        grads = torch.autograd.grad(loss, [t for _, _, t in leaves])
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    for (name, k, _), g in zip(leaves, grads):
        assert _rel(g.numpy(), want_g[name][k]) <= REL, (name, k)


class _JitIsTheEvaluator:
    """``jax`` for one module, its ``jit`` replaced by the TPU-numerics
    evaluator (the JAX package's skip-gram jits its ``lax.scan``)."""

    def __init__(self, passes):
        self.jit = lambda fn: tpu_eval(fn, passes)

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_skipgram_draws(seed, n_walks, walk_len, n_nodes, dim, context,
                        negatives, n_steps, batch):
    """JAX's train_skipgram initial W_in and step draws, from its own key
    schedule (as tests/test_torch_node2vec.py rebuilds them)."""
    key = jax.random.PRNGKey(seed)
    k_in, _, key = jax.random.split(key, 3)
    W_in = (jax.random.uniform(k_in, (n_nodes, dim)) - 0.5) / dim
    steps = []
    for step_key in jax.random.split(key, n_steps):
        kw, kp, ko, kn = jax.random.split(step_key, 4)
        steps.append(SkipgramDraws(*(torch.from_numpy(np.array(x)) for x in (
            jax.random.randint(kw, (batch,), 0, n_walks),
            jax.random.randint(kp, (batch,), 0, walk_len),
            jax.random.randint(ko, (batch,), 1, context + 1),
            jax.random.uniform(kn, (batch,)),
            jax.random.randint(jax.random.fold_in(kn, 1),
                               (batch, negatives), 0, n_nodes)))))
    return torch.from_numpy(np.array(W_in)), steps


SG = dict(n_nodes=30, dim=8, context=3, negatives=5, epochs=2, batch=256,
          seed=9)


def _skipgram_problem():
    walks = np.random.default_rng(1).integers(
        0, SG["n_nodes"], (40, 8)).astype(np.int32)
    n_steps = skipgram_steps(40, 8, SG["context"], SG["epochs"],
                             SG["batch"])
    W_in, steps = _jax_skipgram_draws(
        SG["seed"], 40, 8, SG["n_nodes"], SG["dim"], SG["context"],
        SG["negatives"], n_steps, SG["batch"])
    return walks, W_in, steps


def _port_skipgram(walks, W_in, steps, dtype=torch.float32):
    kw = {k: v for k, v in SG.items() if k != "n_nodes"}
    return train_skipgram(torch.from_numpy(walks), SG["n_nodes"],
                          W_in=W_in.to(dtype),
                          draws=lambda step: steps[step], **kw)


@pytest.mark.parametrize("value", list(VALUES))
def test_skipgram_steps_match_jax_at_tpu_numerics(value, monkeypatch):
    """Seven skip-gram steps on JAX's initial W_in and draws against the
    JAX package's ``train_skipgram`` with its scanned step run at the
    TPU's numerics (its two ``einsum``s rounded, the rest f32): the
    change of W_in within SKIPGRAM_TOL of JAX's, and not the f32 run's
    bits."""
    walks, W_in, steps = _skipgram_problem()
    assert len(steps) == 7
    monkeypatch.setattr(jn2v, "jax", _JitIsTheEvaluator(VALUES[value]))
    kw = {k: v for k, v in SG.items() if k != "n_nodes"}
    want = np.asarray(jn2v.train_skipgram(jnp.asarray(walks),
                                          SG["n_nodes"], **kw))
    with precision.override(value):
        got = _port_skipgram(walks, W_in, steps)
    w0 = W_in.numpy()
    assert _rel(got - w0, want - w0) <= SKIPGRAM_TOL[value]
    assert not np.array_equal(got, _port_skipgram(walks, W_in, steps))


@pytest.mark.parametrize("value", list(VALUES))
def test_skipgram_matches_the_float64_run_with_the_same_rounding(value):
    """The same steps in float64 (the products of the same bf16-rounded
    operands, every sum in float64): the f32 run's change of W_in within
    TOL, rounding flips being the only place they part by more than
    f32's sums."""
    walks, W_in, steps = _skipgram_problem()
    with precision.override(value):
        got = _port_skipgram(walks, W_in, steps)
        got64 = _port_skipgram(walks, W_in, steps, torch.float64)
    w0 = W_in.numpy()
    assert _rel(got - w0, got64 - w0) <= TOL[value]


# ---- unset is the parent's arithmetic, bit for bit ---------------------


def test_unset_layers_and_skipgram_are_the_f32_ops(monkeypatch):
    """With the variable unset nothing is rounded, and the layers and
    skip-gram give the bits of the ops they ran before the policy
    reached them: ``@`` for the products, the elementwise sums of
    skip-gram, GAT's reassociated form."""
    def refuse(*a, **k):
        raise AssertionError("rounded or einsum'd with the policy unset")

    outs = {}
    walks, W_in, steps = _skipgram_problem()
    for patched in (False, True):
        with monkeypatch.context() as mp, precision.override(None):
            if patched:   # the parent's ops in place of the helpers
                mp.setattr(agg, "bf16_round", refuse)
                mp.setattr(gnnlib, "einsum", refuse)
                mp.setattr(node2vec, "einsum", refuse)
                mp.setattr(gnnlib, "matmul", lambda a, b, passes: a @ b)
            run = []
            for layer in ("sage", "gcn", "gat"):
                p, h_self, h_nb, ct = _layer_inputs(layer, seed=3)
                out, grads = _port_layer(p, layer, h_self, h_nb, ct)
                run += [out, *grads.values()]
            run.append(_port_skipgram(walks, W_in, steps))
            outs[patched] = run
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


# ---- ranking of a GNN table reads no policy -----------------------------


def test_gnn_rows_ranking_is_bit_equal_under_every_value(dataset_dir,
                                                         positives):
    """A GraphSAGE row's kNN and ``rank_eval`` of its table under
    ``default`` and ``high`` equal the unset ones bit for bit."""
    graph = SongGraph(dataset_dir)
    m = GraphSAGE(hidden_dim=8, out_dim=8, steps=2, batch=16, device="cpu")
    m.train(graph, graph.track_ids, positives[:100], None, None)
    nodes = np.arange(50)

    def ranking():
        w, ids = m.knn(nodes, 10)
        return w, ids, rank_eval(m.embedding, positives[:60], hit_ks=(10,),
                                 mrr_k=50, device="cpu")
    want = ranking()
    for value in VALUES:
        with precision.override(value):
            got = ranking()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
