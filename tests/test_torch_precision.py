"""The port's matmul precision policy (``utils.precision``,
``GCN_TPU_MATMUL_PRECISION``) against the JAX package, on the CPU.

On the TPU, JAX's ``default`` precision runs each f32 product as one
bf16 pass with f32 accumulation and ``high`` as three (bf16_3x); XLA on
the CPU ignores the setting and multiplies in f32 (``default`` and
``BF16_BF16_F32`` give bit-equal results there).  So a JAX reference of
the TPU's numerics rounds the operands itself: ``_tpu_product`` wraps a
bilinear JAX op (the model's ``jnp.dot`` and ``jnp.einsum``) so that it
multiplies bf16-rounded operands (or the three products of their hi / lo
split) and, in its custom VJP, runs the transposed products the same
way on the rounded cotangent, as XLA's transposed dots keep the
forward's precision.  ``tpu_numerics`` hands the JAX package's own
model functions (``models/pinsage.py``, which read ``jnp`` from their
module) that wrapped ``jnp`` for one test.

Tolerances: the rounding itself bit-exact (XLA's convert); the
aggregation's forward at tests/test_pallas_agg.py's 2e-5 (the rounded
operands are the same bits in both packages, only the order of the f32
sums differs); where an f32 intermediate is rounded again (the W half
rounds the aggregation, the head its hidden layer, a gradient its
cotangent) two orders of f32 sums can round an entry to neighbouring
bf16 values, 2^-8 apart relative, so those are held at 1e-3 relative
(Frobenius) or 1e-4 absolute on unit-scale values, each stated below.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gcn_song_embeddings_tpu.models import pinsage as jp
from gcn_song_embeddings_tpu.train import loss as jloss
from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
from gcn_song_embeddings_tpu_torch.models.baselines.mf import ALS
from gcn_song_embeddings_tpu_torch.models.pinsage import (
    conv_apply,
    embed_all,
    head_apply,
)
from gcn_song_embeddings_tpu_torch.ops import agg
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.serve import EmbeddingIndex
from gcn_song_embeddings_tpu_torch.train import trainer as ttrainer
from gcn_song_embeddings_tpu_torch.utils import precision
from gcn_song_embeddings_tpu_torch.utils.checkpoint import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5  # tests/test_pallas_agg.py
REL = 1e-3   # relative Frobenius error where an f32 intermediate is
#              rounded again (one flipped bf16 rounding is 2^-8 relative)
N, IN, HID, OUT, L, T, B = 300, 16, 32, 16, 2, 3, 8
PAIRS = {1: ((0, 0),), 3: ((0, 1), (1, 0), (0, 0))}  # hi.lo, lo.hi, hi.hi
VALUES = {"default": 1, "high": 3}


def _jparts(x, passes):
    hi = x.astype(jnp.bfloat16).astype(x.dtype)
    if passes == 1:
        return (hi,)
    return hi, (x - hi).astype(jnp.bfloat16).astype(x.dtype)


def _tpu_product(f, passes):
    """f(a, b), bilinear, as the TPU runs it at JAX's default (1 bf16
    pass) or high (3) precision, forward and backward."""
    def terms(g, xs, ys):
        return sum(g(xs[i], ys[j]) for i, j in PAIRS[passes])

    @jax.custom_vjp
    def prod(a, b):
        return terms(f, _jparts(a, passes), _jparts(b, passes))

    def fwd(a, b):
        return prod(a, b), (a, b)

    def bwd(res, g):
        a, b = res
        gp = _jparts(g, passes)
        da = terms(lambda gi, bj: jax.vjp(lambda x: f(x, bj), a)[1](gi)[0],
                   gp, _jparts(b, passes))
        db = terms(lambda ai, gj: jax.vjp(lambda y: f(ai, y), b)[1](gj)[0],
                   _jparts(a, passes), gp)
        return da, db

    prod.defvjp(fwd, bwd)
    return prod


# tests/tpu_numerics.py is the general form of _TpuNumpy: a jaxpr
# evaluator that rounds every default-precision product of any JAX
# function, ``@`` and the products inside ``lax.scan`` included.
class _TpuNumpy:
    """``jax.numpy`` whose ``dot`` and ``einsum`` multiply as the TPU
    does at a precision."""

    def __init__(self, passes):
        self._passes = passes

    def __getattr__(self, name):
        return getattr(jnp, name)

    def dot(self, a, b, **kw):
        return _tpu_product(lambda x, y: jnp.dot(x, y, **kw),
                            self._passes)(a, b)

    def einsum(self, spec, a, b, **kw):
        return _tpu_product(lambda x, y: jnp.einsum(spec, x, y, **kw),
                            self._passes)(a, b)


@pytest.fixture
def tpu_numerics(monkeypatch):
    """Call with 1 or 3: the JAX package's model functions multiply as
    the TPU does at that many bf16 passes for the rest of the test."""
    def use(passes):
        monkeypatch.setattr(jp, "jnp", _TpuNumpy(passes))
    return use


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---- the policy --------------------------------------------------------


def _jax_takes(value):
    """JAX accepts ``value`` as its default matmul precision, both ways
    the JAX package and the tests set it."""
    with jax.default_matmul_precision(value):
        pass
    before = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", value)
    jax.config.update("jax_default_matmul_precision", before)


# JAX's levels, their aliases (bfloat16 and float32 were once refused:
# JAX ran with them while the port failed at import) and the presets that
# name the port's own forms
@pytest.mark.parametrize("value,passes", [
    ("default", 1), ("high", 3), ("highest", None), ("", None), (None, None),
    ("bfloat16", 1), ("tensorfloat32", 3), ("float32", None),
    ("BF16_BF16_F32", 1), ("BF16_BF16_F32_X3", 3), ("F32_F32_F32", None)])
def test_policy_parses_the_jax_values(value, passes):
    assert precision.parse(value) == passes
    if value:   # one variable drives both packages: JAX takes it too
        _jax_takes(value)


@pytest.mark.parametrize("value", [
    "HIGH", "fast", "BF16_BF16_F32_X6", "TF32_TF32_F32", "F16_F16_F32"])
def test_policy_refuses_any_other_value(value):
    with pytest.raises(ValueError, match="GCN_TPU_MATMUL_PRECISION"):
        precision.parse(value)


@pytest.mark.parametrize("value", precision.UNFORMED)
def test_unformed_presets_are_a_named_divergence(value):
    """JAX takes each preset the port has no form for; the port refuses
    it with a message that names the divergence."""
    _jax_takes(value)
    with pytest.raises(ValueError, match="deliberate divergence") as err:
        precision.parse(value)
    assert value in str(err.value)


def _import_passes(value):
    return subprocess.run(
        [sys.executable, "-c", "from gcn_song_embeddings_tpu_torch.utils "
         "import precision; print(precision.PASSES)"],
        env={**os.environ, precision.ENV: value}, cwd=REPO,
        capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("value,passes", [
    ("default", "1"), ("high", "3"), ("highest", "None"), ("", "None"),
    ("bfloat16", "1")])
def test_variable_is_read_at_import(value, passes):
    out = _import_passes(value)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == passes


def test_a_bad_variable_fails_the_import():
    out = _import_passes("medium")
    assert out.returncode != 0
    assert "GCN_TPU_MATMUL_PRECISION" in out.stderr


def test_override_restores_the_policy():
    before = precision.PASSES
    with precision.override("high") as passes:
        assert passes == precision.PASSES == 3
    assert precision.PASSES == before


# ---- rounding ----------------------------------------------------------


def _rounding_inputs():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4000) * s for s in (1e-3, 1.0, 1e3)]).astype(
            np.float32)
    # halfway cases (ties to even both ways), subnormals, the largest
    # finite f32 (rounds past bf16's range), infinities, signed zeros
    halves = ((np.arange(0x3F80, 0x3FC0, dtype=np.uint32) << 16)
              | 0x8000)
    halves = np.concatenate([halves, halves | 0x80000000])
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-39,
                        np.finfo(np.float32).max, 3.3895314e38],
                       np.float32)
    return np.concatenate([x, halves.view(np.float32), special])


def test_bf16_round_is_xlas_convert_bit_for_bit():
    x = _rounding_inputs()
    got = agg.bf16_round(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_bf16_split3_is_xlas_hi_and_lo_bit_for_bit():
    x = _rounding_inputs()
    # finite and normal: XLA on the CPU flushes a subnormal difference to
    # +0, where PyTorch's keeps its sign (-0 and +0 add alike)
    x = x[np.isfinite(x) & ((np.abs(x) >= np.finfo(np.float32).tiny)
                            | (x == 0))]
    hi, lo = agg.bf16_split3(torch.from_numpy(x))
    jhi, jlo = _jparts(jnp.asarray(x), 3)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  np.asarray(jhi).view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  np.asarray(jlo).view(np.uint32))
    # hi + lo carries 16 significant bits of x (where hi stays finite)
    big = (np.abs(x) > 1e-30) & np.isfinite(hi.numpy())
    err = np.abs(hi.numpy() + lo.numpy() - x)[big] / np.abs(x[big])
    assert err.max() <= 2.0 ** -16


@pytest.mark.parametrize("passes", [1, 3])
def test_matmul_passes_are_the_rounded_products(passes):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 24)).astype(np.float32)
    b = rng.normal(size=(24, 8)).astype(np.float32)
    got = agg.matmul(torch.from_numpy(a), torch.from_numpy(b), passes)
    want = _tpu_product(jnp.dot, passes)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="passes"):
        agg.matmul(torch.from_numpy(a), torch.from_numpy(b), 2)


# ---- the aggregation (the plain versions of K2's and K3's bf16x forms) --


def _agg_problem(b=200, t=3, n=500, din=64, h=48, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((b, t)).astype(np.float32)
    w[3] = 0.0                                # the all-zero guard
    return [rng.normal(size=(n, din)).astype(np.float32),
            rng.integers(0, n, (b, t)).astype(np.int32), w,
            (rng.normal(size=(h, din)) * .1).astype(np.float32),
            np.full(h, 0.3, np.float32)]


def _jax_aggregate(h, nb, w, Wq, bq, einsum):
    """The aggregation of the JAX package's ``conv_apply``
    (models/pinsage.py): its Q einsum through ``einsum``."""
    q = jax.nn.leaky_relu(einsum(h[nb], Wq) + bq)
    w_sum = w.sum(axis=1, keepdims=True)
    denom = jnp.where(w_sum == 0.0, 1.0, w_sum)
    return (w[:, :, None] * q).sum(axis=1) / denom


def _q_einsum(passes):
    return _tpu_product(lambda x, y: jnp.einsum(
        "btd,hd->bth", x, y, preferred_element_type=jnp.float32), passes)


@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("mode", ["stream", "dma"])
def test_aggregation_matches_the_rounded_jax_einsum(value, mode):
    arrays = _agg_problem()
    want = _jax_aggregate(*(jnp.asarray(a) for a in arrays),
                          _q_einsum(VALUES[value]))
    before = (agg.launches_bf16x1, agg.launches_bf16x3)
    with precision.override(value):
        got = agg.conv_aggregate(*(torch.from_numpy(a) for a in arrays),
                                 mode=mode)
    assert (agg.launches_bf16x1, agg.launches_bf16x3) == before  # plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    f32 = agg.conv_aggregate(*(torch.from_numpy(a) for a in arrays))
    assert not torch.equal(got, f32)          # the policy took effect


@pytest.mark.parametrize("passes", [1, 3])
def test_projection_plain_matches_the_rounded_jax_product(passes):
    h, _, _, Wq, bq = _agg_problem(seed=2)
    got = agg.project_table_plain(torch.from_numpy(h), torch.from_numpy(Wq),
                                  torch.from_numpy(bq), passes)
    want = jax.nn.leaky_relu(_tpu_product(jnp.dot, passes)(
        jnp.asarray(h), jnp.asarray(Wq).T) + bq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("path", ["autograd", "table"])
def test_aggregation_backward_matches_jax_vjp(passes, path):
    """dh, dWq and dbq of the aggregation against ``jax.vjp`` of the same
    function with the TPU's rounded Q einsum (cotangent rounded in its
    transposed products): through autograd of the plain version (the
    CPU path) and through ``ConvAggregate.backward``'s table form (the
    card's path, which sums each table row's rounded row gradients
    before multiplying: the same sums in another order), within 1e-5 of
    each gradient's largest entry (f32 sums of gradients up to ~20 in
    another order)."""
    arrays = _agg_problem(b=120, t=4, n=300, seed=3)
    dagg = np.random.default_rng(4).normal(size=(120, 48)).astype(
        np.float32)
    h, nb, w, Wq, bq = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda h_, Wq_, bq_: _jax_aggregate(
        h_, nb, w, Wq_, bq_, _q_einsum(passes)), h, Wq, bq)
    want = vjp(jnp.asarray(dagg))
    th, tWq, tbq = (torch.from_numpy(arrays[i]).requires_grad_()
                    for i in (0, 3, 4))
    tnb, tw = torch.from_numpy(arrays[1]), torch.from_numpy(arrays[2])
    if path == "autograd":
        out = agg.conv_aggregate_plain(th, tnb, tw, tWq, tbq, passes)
    else:
        out = agg.ConvAggregate.apply(th, tnb, tw, tWq, tbq, "dma", None,
                                      passes)
    got = torch.autograd.grad(out, (th, tWq, tbq), torch.from_numpy(dagg))
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt,
                                   atol=1e-5 * np.abs(wnt).max())


def test_the_cuda_entry_refuses_passes_on_a_16bit_table():
    h, nb, w, Wq, bq = (torch.from_numpy(a) for a in _agg_problem())
    with pytest.raises(ValueError, match="16-bit"):
        agg.conv_aggregate_cuda(h.bfloat16(), nb, w, Wq.bfloat16(), bq,
                                passes=1)
    with pytest.raises(ValueError, match="passes"):
        agg.conv_aggregate_cuda(h, nb, w, Wq, bq, passes=2)


# ---- the W half, the head and the whole step ----------------------------


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, IN)).astype(np.float32)
    w = np.sort(rng.random((N, T + 2)).astype(np.float32), axis=1)[:, ::-1]
    w[::7, T - 1:] = 0.0
    w[5] = 0.0
    nodes = rng.integers(0, N, (N, T + 2)).astype(np.int32)
    return feats, np.ascontiguousarray(w), nodes


def _jax_params(seed=0):
    return jp.init_pinsage(jax.random.PRNGKey(seed), L, IN, HID, OUT)


def _port_params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


@pytest.mark.parametrize("value", list(VALUES))
def test_conv_layer_and_head_match_jax_at_tpu_numerics(value,
                                                       tpu_numerics):
    """One conv layer (aggregation, W half, norm) and the head against
    the JAX package's ``conv_apply`` and ``head_apply`` multiplying as
    the TPU does; the W half and the head's second product round an f32
    intermediate again (absolute 1e-4 on unit-norm rows, REL on the
    head)."""
    rng = np.random.default_rng(5)
    jparams = _jax_params(1)
    params = _port_params(jparams)
    h_self = rng.normal(size=(64, IN)).astype(np.float32)
    h_nb = rng.normal(size=(64, T, IN)).astype(np.float32)
    nb_w = rng.random((64, T)).astype(np.float32)
    x = rng.normal(size=(64, OUT)).astype(np.float32)
    tpu_numerics(VALUES[value])
    want_conv = jp.conv_apply(jparams.layers[0], jnp.asarray(h_self),
                              jnp.asarray(h_nb), jnp.asarray(nb_w))
    want_head = jp.head_apply(jparams, jnp.asarray(x))
    with precision.override(value), torch.no_grad():
        got_conv = conv_apply(params.layers[0], torch.from_numpy(h_self),
                              torch.from_numpy(h_nb), torch.from_numpy(nb_w))
        got_head = head_apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(got_conv.numpy(), np.asarray(want_conv),
                               atol=1e-4)
    assert _rel(got_head.numpy(), want_head) <= REL
    with torch.no_grad():
        f32 = head_apply(params, torch.from_numpy(x))
    assert not torch.equal(got_head, f32)


def _jax_loss_fn(feats, w, nodes, batch, margin, fullgraph=False):
    packed = jp.pack_nbhds(jnp.asarray(w), jnp.asarray(nodes), T)
    f = jnp.asarray(feats)
    b = jnp.asarray(batch)
    nodeset = jnp.concatenate([b[:, 0], b[:, 1], b[:, 2]])

    def loss_fn(params):
        if fullgraph:   # pinsage_forward_fullgraph's body: it is jitted,
            # and a jitted trace would keep the first test's jnp
            emb = jp.head_apply(params, jp.fullgraph_embeddings(
                params, f, jnp.asarray(w), jnp.asarray(nodes), L, T)[nodeset])
        else:
            emb = jp.forward_with_gather(
                params, lambda ids: f[ids], jp.packed_nbhd_gather(packed, T),
                nodeset, L, T)
        h_q, h_pos, h_neg = jnp.split(emb, 3, axis=0)
        return jloss.max_margin_loss(h_q, h_pos, h_neg, margin)
    return loss_fn


def _cfgs():
    from gcn_song_embeddings_tpu_torch.config import (
        PinSageConfig,
        TrainConfig,
    )
    return (TrainConfig(lr=1e-3, margin=0.1, batch_size=B,
                        batches_per_epoch=2, decay=0.5),
            PinSageConfig(in_dim=IN, hidden_dim=HID, out_dim=OUT,
                          n_layers=L, T=T))


def _batch(seed=1):
    return np.random.default_rng(seed).integers(0, N, (B, 3)).astype(
        np.int32)


def _port_loss_grads(params, feats, w, nodes, batch, fullgraph,
                     dtype=torch.float32):
    tcfg, mcfg = _cfgs()
    tables = ttrainer.TrainTables.build(feats, w, nodes, T)
    if dtype != torch.float32:   # the float64 reference of the same step
        params = params.to(dtype)
        f = tables.features.to(dtype)
        tables = tables._replace(features=f, step_features=f)
    loss, _ = ttrainer.triple_loss(params, tables, torch.from_numpy(batch),
                                   tcfg, mcfg, fullgraph)
    grads = torch.autograd.grad(loss, [p for _, p in params.leaves()])
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("fullgraph", [False, True])
def test_step_matches_jax_at_tpu_numerics(value, fullgraph, tpu_numerics):
    """The loss and every gradient of one batch against
    ``jax.value_and_grad`` of the JAX package's forward (frontier, or
    full graph) and loss multiplying as the TPU does: loss within 1e-5,
    each gradient within REL of JAX's.  (Rounded, the two forwards part:
    a node the frontier reaches twice has its row gradients rounded one
    by one there and summed first in the full graph's table, so each is
    held to JAX's own forward of its kind.)"""
    feats, w, nodes = _problem()
    batch = _batch()
    jparams = _jax_params()
    tpu_numerics(VALUES[value])
    want_loss, want_grads = jax.value_and_grad(
        _jax_loss_fn(feats, w, nodes, batch, 0.1, fullgraph))(jparams)
    with precision.override(value):
        loss, grads = _port_loss_grads(_port_params(jparams), feats, w,
                                       nodes, batch, fullgraph)
    assert abs(loss - float(want_loss)) <= 1e-5
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(
        _jax_leaf_order(want_grads))]
    for g, wnt in zip(grads, want):
        assert _rel(g, wnt) <= REL


def _jax_leaf_order(params):
    return ([getattr(layer, f) for layer in params.layers
             for f in ("Wq", "bq", "Ww", "bw")]
            + [params.G1_w, params.G1_b, params.G2_w])


@pytest.mark.parametrize("value", list(VALUES))
def test_step_matches_the_float64_step_with_the_same_rounding(value):
    """The same step in float64 (products of the same bf16-rounded
    operands, sums in float64): the f32 step's loss within 1e-5 and each
    gradient within REL, the rounding of an intermediate being the only
    place the two can part by more than f32's sums."""
    feats, w, nodes = _problem(2)
    batch = _batch(3)
    jparams = _jax_params(2)
    with precision.override(value):
        loss, grads = _port_loss_grads(_port_params(jparams), feats, w,
                                       nodes, batch, False)
        loss64, grads64 = _port_loss_grads(_port_params(jparams), feats, w,
                                           nodes, batch, False,
                                           torch.float64)
    assert abs(loss - loss64) <= 1e-5
    for g, g64 in zip(grads, grads64):
        assert _rel(g, g64) <= REL


def test_default_trainer_steps_stay_near_jaxs_f32_steps():
    """Three ``default`` steps of the port's trainer against the JAX
    package's f32 steps on the CPU (which ignore the precision: see the
    module docstring), at a bf16-scale bound: losses within 1e-2
    relative, parameters within 6e-3 (three Adam steps of 1e-3 each way,
    where a gradient entry near 0 takes the other sign).  This catches
    wiring faults only; the numerics are held above."""
    import optax

    from gcn_song_embeddings_tpu.config import (
        PinSageConfig as JPinSageConfig,
        RunConfig as JRunConfig,
        TrainConfig as JTrainConfig,
    )
    from gcn_song_embeddings_tpu.train.trainer import make_optimizer

    feats, w, nodes = _problem(4)
    batches = [_batch(s) for s in (5, 6, 7)]
    jparams = _jax_params(3)
    tcfg, mcfg = _cfgs()
    jcfg = JRunConfig(train=JTrainConfig(lr=1e-3, margin=0.1, batch_size=B,
                                         batches_per_epoch=2, decay=0.5),
                      model=JPinSageConfig(in_dim=IN, hidden_dim=HID,
                                           out_dim=OUT, n_layers=L, T=T))
    tx = make_optimizer(jcfg)
    opt_state = tx.init(jparams)
    params = _port_params(jparams)
    want_losses = []
    for batch in batches:
        loss, grads = jax.value_and_grad(
            _jax_loss_fn(feats, w, nodes, batch, 0.1))(jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_losses.append(float(loss))
    opt = ttrainer.make_optimizer(params, tcfg)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T)
    with precision.override("default"):
        losses = [float(ttrainer.train_step(
            params, opt, torch.from_numpy(b), tables, tcfg, mcfg,
            fullgraph=False)[0]) for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
    for (_, got), want in zip(params.leaves(), _jax_leaf_order(jparams)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=6e-3)


def test_unset_runs_no_rounding_and_is_the_f32_step(monkeypatch):
    """With the variable unset the step is the f32-accurate one: no
    operand is rounded, and ``highest`` gives it bit for bit."""
    feats, w, nodes = _problem(6)
    batch = _batch(8)
    params = _port_params(_jax_params(4))
    with precision.override("highest"):
        want = _port_loss_grads(params, feats, w, nodes, batch, False)

    def refuse(x):
        raise AssertionError("an operand was rounded with the policy unset")
    monkeypatch.setattr(agg, "bf16_round", refuse)
    with precision.override(None):
        got = _port_loss_grads(params, feats, w, nodes, batch, False)
        got_fg = _port_loss_grads(params, feats, w, nodes, batch, True)
    assert got[0] == want[0]
    for g, wnt in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, wnt)
    assert np.isfinite(got_fg[0])


def test_embed_follows_the_policy():
    feats, w, nodes = _problem(7)
    params = _port_params(_jax_params(5))
    args = (params, torch.from_numpy(feats), torch.from_numpy(w),
            torch.from_numpy(nodes), N, L, T)
    f32 = embed_all(*args)
    with precision.override("default"):
        one = embed_all(*args)
    with precision.override("high"):
        three = embed_all(*args)
    assert not torch.equal(one, f32)
    # three passes carry 16 significant bits: closer to f32 than one
    assert _rel(three, f32) < _rel(one, f32) <= 2e-2


# ---- ranking stays f32 ----------------------------------------------------


def _ranking(emb, pairs, ratings):
    w, n = knn_from_emb(emb, k=10, device="cpu")
    ranks = rank_eval(emb, pairs, hit_ks=(10,), mrr_k=50, device="cpu")
    rows = np.array([0, 7, 99])
    served = [[(o["index"], o["score"]) for o in r] for r in EmbeddingIndex(
        emb, device="cpu").knn_rows(rows, 5)]
    served8 = [[(o["index"], o["score"]) for o in r] for r in EmbeddingIndex(
        emb, quantized=True, device="cpu").knn_rows(rows, 5)]
    als = ALS(factors=8, iterations=2, device="cpu")
    als.fit(ratings)
    return w, n, ranks, served, served8, als.item_factors


@pytest.mark.parametrize("value", ["default", "high", "highest"])
def test_ranking_is_bit_equal_under_every_value(value):
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(200, 16)).astype(np.float32)
    pairs = rng.integers(0, 200, (40, 2))
    ratings = sp.random(30, 200, density=0.05, random_state=1,
                        format="csr", dtype=np.float32)
    want = _ranking(emb, pairs, ratings)
    with precision.override(value):
        got = _ranking(emb, pairs, ratings)
    for g, wnt in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, wnt)
        else:
            assert g == wnt


# ---- colisten_ab under the policy, at a train seed --------------------


def test_colisten_ab_names_the_seed_and_the_precision(tmp_path,
                                                      monkeypatch):
    """``--train-seed 2`` trains each PinSage arm at ``train.seed`` 2 as
    ``<arm>_s2``, its row naming the seed and the policy's value; a rerun
    skips the rows written (the trainer stands in: its run is
    tests/test_torch_colisten_ab.py's)."""
    from gcn_song_embeddings_tpu_torch import colisten_ab as ab

    cfgs = []

    class Trained:
        def train(self):
            pass

        def embed(self):
            return np.random.default_rng(0).normal(size=(50, 8)).astype(
                np.float32)

    def trainer(data, cfg, work, verbose=True):
        cfgs.append(cfg)
        return Trained()

    monkeypatch.setattr(ab, "pinsage_trainer", trainer)
    monkeypatch.setenv(precision.ENV, "default")
    data = ab.Data(None, None, None, np.array([[0, 1], [2, 3], [4, 9]]),
                   str(tmp_path))
    args = ab.parse_args(["--work-dir", str(tmp_path), "--arms",
                          "co1_T10,co1_T10_wide", "--train-seed", "2",
                          "--device", "cpu"])
    with precision.override("default"):
        rows = ab.run(args, lambda *a: None, data=data)
        again = ab.run(args, lambda *a: None, data=data)
    assert list(rows) == ["co1_T10_s2", "co1_T10_wide_s2"]
    assert [(c.run_name, c.train.seed) for c in cfgs] == [
        ("co1_T10_s2", 2), ("co1_T10_wide_s2", 2)]
    assert cfgs[1].model.hidden_dim == 1024
    for row in rows.values():
        assert row["train_seed"] == 2
        assert row["matmul_precision"] == "default"
    assert again == {}
