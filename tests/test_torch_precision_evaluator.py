"""``tests/tpu_numerics.py``'s jaxpr evaluator (the TPU's matmul numerics
for any JAX function on the CPU), the inventory of the products the
JAX package's default precision reaches, and the port's rounded product
helpers (``ops.agg``: ``matmul``, ``einsum``, ``conv2d``, ``linear``)
against the evaluator.

Tolerances: the evaluator against ``tests/test_torch_precision.py``'s
``_TpuNumpy`` and the helpers against the evaluator at 2e-5 absolute on
unit-scale values (the same rounded operands, the f32 sums in another
order); a jitted rounding against the eager one bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax import lax

from gcn_song_embeddings_tpu import features as JF
from gcn_song_embeddings_tpu.models import audio_embedders as J
from gcn_song_embeddings_tpu.models import gnnlib as jgnn
from gcn_song_embeddings_tpu.models import pinsage as jp
from gcn_song_embeddings_tpu.models.baselines import mf as jmf
from gcn_song_embeddings_tpu.models.baselines import node2vec as jn2v
from gcn_song_embeddings_tpu_torch.models import audio_embedders as P
from gcn_song_embeddings_tpu_torch.ops import agg
from test_torch_precision import _TpuNumpy
from torch_threads import one_torch_thread  # noqa: F401
from tpu_numerics import parts, products, tpu_eval

ATOL = 2e-5
PASSES = [1, 3]


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---- the evaluator -------------------------------------------------------


@pytest.mark.parametrize("passes", PASSES)
def test_jitted_rounding_is_the_eager_rounding(passes):
    """XLA on the CPU keeps each f32 -> bf16 -> f32 round trip under
    ``jax.jit``: the evaluator's product equals the eager sum of the
    rounded parts' products bit for bit."""
    rng = np.random.default_rng(0)
    a, b = jnp.asarray(_normal(rng, 33, 20)), jnp.asarray(_normal(rng, 20, 7))
    got = tpu_eval(jnp.dot, passes)(a, b)
    ap, bp = parts(a, passes), parts(b, passes)
    pairs = ((0, 0),) if passes == 1 else ((0, 1), (1, 0), (0, 0))
    want = sum(jnp.dot(ap[i], bp[j]) for i, j in pairs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert not np.array_equal(np.asarray(got), np.asarray(a @ b))


@pytest.mark.parametrize("passes", PASSES)
def test_evaluator_is_tpu_numpy_on_pinsage_conv_apply(passes, monkeypatch):
    """PinSage's ``conv_apply`` (models/pinsage.py) and its gradients
    through the evaluator against the same function with
    ``tests/test_torch_precision.py``'s ``_TpuNumpy`` in place of the
    module's ``jnp`` (its products wrapped in a custom VJP that rounds
    the cotangent)."""
    rng = np.random.default_rng(1)
    params = jp.init_pinsage(jax.random.PRNGKey(0), 1, 16, 24, 12)
    layer = params.layers[0]
    args = (jnp.asarray(_normal(rng, 20, 16)),
            jnp.asarray(_normal(rng, 20, 3, 16)),
            jnp.asarray(rng.random((20, 3)).astype(np.float32)))
    ct = jnp.asarray(_normal(rng, 20, 12))

    def fwd_bwd():   # a new function each call: JAX caches its traces
        def run(lyr, h_self, h_nb, w):
            out, vjp = jax.vjp(lambda p, a, b: jp.conv_apply(p, a, b, w),
                               lyr, h_self, h_nb)
            return out, vjp(ct)
        return run

    got = tpu_eval(fwd_bwd(), passes)(layer, *args)
    monkeypatch.setattr(jp, "jnp", _TpuNumpy(passes))
    want = jax.jit(fwd_bwd())(layer, *args)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL)


def test_evaluator_leaves_pinned_and_integer_products_alone():
    """A product pinned at HIGHEST, and an int8 one, are bound as they
    are: the evaluator returns the f32 (and exact integer) results."""
    rng = np.random.default_rng(2)
    a, b = jnp.asarray(_normal(rng, 9, 5)), jnp.asarray(_normal(rng, 5, 4))
    qa = jnp.asarray(rng.integers(-127, 128, (9, 5)), jnp.int8)
    qb = jnp.asarray(rng.integers(-127, 128, (5, 4)), jnp.int8)

    def f(a, b, qa, qb):
        return (jnp.dot(a, b, precision=lax.Precision.HIGHEST),
                lax.dot_general(qa, qb, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32))

    got, want = tpu_eval(f, 1)(a, b, qa, qb), f(a, b, qa, qb)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_evaluator_refuses_a_loop_it_cannot_round():
    def f(x):
        return lax.while_loop(lambda c: c[1] < 3,
                              lambda c: (c[0] @ c[0], c[1] + 1), (x, 0))[0]
    with pytest.raises(NotImplementedError, match="while"):
        tpu_eval(f, 1)(jnp.eye(3))


# ---- the inventory of the default precision's reach -------------------


def _rounded(found):
    return [p for p in found if p[3]]


def _gnn_products(layer):
    p = jgnn.init_gnn_layer(jax.random.PRNGKey(0), layer, 8, 4)
    hs, hn = jnp.ones((3, 8)), jnp.ones((3, 2, 8))
    return products(jax.grad(lambda p_: jgnn.gnn_layer_apply(
        p_, layer, hs, hn).sum()), p)


class _RecordingJax:
    """``jax`` for one module, its ``jit`` recording the products of the
    function it compiles at its first call's arguments."""

    def __init__(self, found):
        self.found = found

    def jit(self, fn):
        def run(*args):
            self.found += products(fn, *args)
            return jax.jit(fn)(*args)
        return run

    def __getattr__(self, name):
        return getattr(jax, name)


def _scanned_products(monkeypatch, module, call):
    found = []
    monkeypatch.setattr(module, "jax", _RecordingJax(found))
    call()
    return found


def _abstract(tree):
    return jax.tree_util.tree_map(
        lambda v: jax.ShapeDtypeStruct(np.shape(v), jnp.float32), tree)


def test_the_default_precision_reaches_the_slice(monkeypatch):
    """The JAX functions this slice ports under the policy hold
    default-precision f32 products (forward, and a grad's transposes):
    the GNN layers, skip-gram's scanned step, the mel and MFCC DCT
    products, and the three nets' convolutions and dense layers."""
    for layer in ("sage", "gcn", "gat"):
        fwd = _rounded(products(lambda hs, hn: jgnn.gnn_layer_apply(
            jgnn.init_gnn_layer(jax.random.PRNGKey(0), layer, 8, 4), layer,
            hs, hn), jnp.ones((3, 8)), jnp.ones((3, 2, 8))))
        grad = _rounded(_gnn_products(layer))
        assert len(fwd) == (6 if layer == "gat" else 1), layer
        assert len(grad) > len(fwd), layer
    walks = jnp.asarray(np.random.default_rng(0).integers(0, 10, (6, 5)),
                        jnp.int32)
    n2v = _scanned_products(monkeypatch, jn2v, lambda: jn2v.train_skipgram(
        walks, 10, dim=4, context=2, epochs=1, batch=16))
    assert len(_rounded(n2v)) == 2                  # its two einsums
    m = JF.MFCC(n_mfcc=8)
    mfcc = _rounded(products(
        lambda c: JF._mfcc_batch_jax(c, jnp.asarray(m._fb),
                                     jnp.asarray(m._dct),
                                     jnp.asarray(m._window), m.n_fft, m.hop,
                                     8), jnp.ones((1, 4096))))
    assert len(mfcc) == 2                           # mel, DCT
    nets = {"openl3": (P.OpenL3Net, J.openl3_forward, (1, 128, 199), 8, 0),
            "vggish": (P.VGGishNet, J.vggish_forward, (1, 96, 64), 6, 3),
            "musicnn": (P.MusicNNNet,
                        lambda p, x: J.musicnn_forward(p, x,
                                                       feature="taggram"),
                        (1, 187, 96), 8, 2)}
    for name, (cls, fwd_fn, shape, convs, dense) in nets.items():
        found = _rounded(products(fwd_fn, _abstract(P.template_tree(cls)),
                                  jax.ShapeDtypeStruct(shape, jnp.float32)))
        kinds = [p[0] for p in found]
        assert kinds.count("conv_general_dilated") == convs, name
        assert kinds.count("dot_general") == dense, name


def test_bpr_lmf_and_als_hold_no_default_precision_product(monkeypatch):
    """BPR's and LMF's SGD epochs score with elementwise products and
    sums, so their jaxprs hold no floating product the policy could
    reach; ALS's normal equations and solve hold only products pinned at
    HIGHEST."""
    mat = sp.random(20, 30, density=0.2, random_state=3, format="csr",
                    dtype=np.float32)
    for cls in (jmf.BPR, jmf.LMF):
        found = _scanned_products(monkeypatch, jmf, lambda: cls(
            factors=4, iterations=1, batch=8).fit(mat))
        assert not [p for p in found if "float32" in p[2]], cls.__name__
    found = []

    class _RecordingNumpy:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def dot(self, *a, **kw):
            nonlocal found
            found += products(lambda *x: jnp.dot(*x, **kw), *a)
            return jnp.dot(*a, **kw)

    solve = jmf._als_solve_block

    def recording_solve(*args):
        nonlocal found
        found += products(lambda *x: solve(*x), *args)
        return solve(*args)

    monkeypatch.setattr(jmf, "jnp", _RecordingNumpy())
    monkeypatch.setattr(jmf, "_als_solve_block", recording_solve)
    jmf.ALS(factors=4, iterations=1).fit(mat)
    assert found and not _rounded(found)
    assert {p[1] for p in found} == {
        (lax.Precision.HIGHEST, lax.Precision.HIGHEST)}


# ---- the port's helpers against the evaluator ----------------------------


@pytest.mark.parametrize("passes", PASSES)
@pytest.mark.parametrize("spec,sa,sb", [
    ("ms,msd->md", (6, 4), (6, 4, 5)), ("bd,bnd->bn", (7, 3), (7, 2, 3)),
    ("md,d->m", (5, 8), (8,)), ("ik,kj->ij", (4, 6), (6, 3))])
def test_einsum_and_its_grads_match_the_rounded_jax_einsum(spec, sa, sb,
                                                           passes):
    rng = np.random.default_rng(4)
    a, b = _normal(rng, *sa), _normal(rng, *sb)
    out_shape = np.einsum(spec, a, b).shape
    ct = _normal(rng, *out_shape)

    def jax_fn(x, y, c):
        out, vjp = jax.vjp(lambda p, q: jnp.einsum(spec, p, q), x, y)
        return out, vjp(c)

    want, (wa, wb) = tpu_eval(jax_fn, passes)(a, b, ct)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    out = agg.einsum(spec, ta, tb, passes)
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(ct))
    for g, w in ((out, want), (ga, wa), (gb, wb)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL)
    np.testing.assert_array_equal(agg.einsum(spec, ta, tb).detach().numpy(),
                                  torch.einsum(spec, ta, tb).detach().numpy())


@pytest.mark.parametrize("passes", PASSES)
def test_batched_matmul_grads_match_the_rounded_jax_product(passes):
    rng = np.random.default_rng(5)
    a, b, ct = _normal(rng, 3, 4, 6), _normal(rng, 6, 5), _normal(rng, 3, 4, 5)

    def jax_fn(x, y, c):
        out, vjp = jax.vjp(jnp.matmul, x, y)
        return out, vjp(c)

    want = jax.tree_util.tree_leaves(tpu_eval(jax_fn, passes)(a, b, ct))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    out = agg.matmul(ta, tb, passes)
    got = [out, *torch.autograd.grad(out, (ta, tb), torch.from_numpy(ct))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL)


@pytest.mark.parametrize("passes", PASSES)
def test_conv2d_and_linear_match_the_rounded_jax_ops(passes):
    """``agg.conv2d`` (NCHW, OIHW, padding) and ``agg.linear`` against
    the JAX package's form, ``conv_general_dilated`` (NHWC, HWIO) + bias
    and ``x @ w + b``, run at the TPU's numerics; unrounded, each is the
    plain op bit for bit."""
    rng = np.random.default_rng(6)
    x, w, b = _normal(rng, 2, 3, 9, 7), _normal(rng, 5, 3, 3, 2), \
        _normal(rng, 5)
    want = tpu_eval(lambda x_, w_, b_: lax.conv_general_dilated(
        x_, w_, (1, 1), ((1, 1), (0, 0)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b_, passes)(
        x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0), b)
    tx, tw, tb = (torch.from_numpy(v) for v in (x, w, b))
    got = agg.conv2d(tx, tw, passes, bias=tb, padding=(1, 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(
        0, 3, 1, 2), atol=ATOL)
    np.testing.assert_array_equal(
        agg.conv2d(tx, tw, None, bias=tb, padding=(1, 0)).numpy(),
        torch.nn.functional.conv2d(tx, tw, tb, padding=(1, 0)).numpy())
    v, fw, fb = _normal(rng, 4, 10), _normal(rng, 6, 10), _normal(rng, 6)
    want = tpu_eval(lambda v_, w_, b_: v_ @ w_ + b_, passes)(v, fw.T, fb)
    tv, tfw, tfb = (torch.from_numpy(a) for a in (v, fw, fb))
    np.testing.assert_allclose(agg.linear(tv, tfw, tfb, passes).numpy(),
                               np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(
        agg.linear(tv, tfw, tfb).numpy(),
        torch.nn.functional.linear(tv, tfw, tfb).numpy())


def test_einsum_refuses_what_its_backward_cannot_transpose():
    a, b = torch.ones(3, 3), torch.ones(3)
    for spec in ("ii,i->i", "ij,j", "ij,k->k", "...j,j->..."):
        with pytest.raises(ValueError, match="einsum"):
            agg.einsum(spec, a, b, 1)
