"""The TPU's matmul numerics for any JAX function, evaluated on the CPU.

On the TPU, JAX's default matmul precision (``GCN_TPU_MATMUL_PRECISION``,
``gcn_song_embeddings_tpu/__init__.py``) runs each f32 product as one
bf16 pass with f32 accumulation (``default``) or as three (``high``:
hi*lo + lo*hi + hi*hi, hi = bf16(x), lo = bf16(x - hi)).  XLA on the CPU
ignores the setting and multiplies in f32, so a CPU reference of the
TPU's numerics has to round the operands itself.

``tpu_eval(fn, passes)`` traces ``fn`` to a jaxpr and evaluates it
equation by equation.  It rebinds two primitives and binds every other
one as it is:

- ``dot_general`` and ``conv_general_dilated`` whose ``precision``
  param is None and whose two operands are f32 run on bf16-rounded
  operands (``passes`` 1) or as the three products of their hi / lo
  split (``passes`` 3).  Each product of bf16 values is exact in f32, so
  only the order of the f32 sums is XLA's.  Float64 operands are rounded
  the same way: under ``jax.enable_x64`` a test gets the float64
  reference of the same rounding, whose sums are near exact.
- A product with a precision of its own (``HIGHEST``: ranking, the ALS
  normal equations) is one the code pinned; the global setting does not
  reach it on the TPU, so it is bound as it is.  So are products of
  integer operands (the int8 serving dot, exact on the MXU) and of
  16-bit ones (already one bf16 pass's input).

It recurses into ``jit`` (pjit), ``custom_jvp_call`` and
``custom_vjp_call`` (their primal jaxprs: a test differentiates before
it traces) and runs a ``scan`` again with its body evaluated the same
way, so the products inside ``lax.scan`` (a scanned trainer's step) are
reached; a ``while`` or ``cond``, or another primitive whose jaxpr
holds a product, raises rather than bind that product unrounded.  The jaxpr of
``jax.grad(f)`` already holds the transposed products, with
``precision`` None as XLA keeps the forward's, so the cotangent is
rounded too, as on the TPU.  The evaluation itself runs under
``jax.jit``: XLA on the CPU keeps each f32 -> bf16 -> f32 round trip
(``tests/test_torch_precision_evaluator.py`` holds a jitted rounding to
the eager one bit for bit).

This is the general form of ``tests/test_torch_precision.py``'s
``_TpuNumpy``, which swaps one module's ``jnp`` and so cannot reach an
``@`` or the products inside a ``lax.scan``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.extend import core as jcore

PAIRS = {1: ((0, 0),), 3: ((0, 1), (1, 0), (0, 0))}  # hi.lo, lo.hi, hi.hi
PRODUCTS = ("dot_general", "conv_general_dilated")
CALLS = ("jit", "pjit", "closed_call", "core_call", "custom_jvp_call",
         "custom_vjp_call", "custom_vjp_call_jaxpr")


def parts(x, passes):
    """(bf16(x),) for one pass, (hi, lo) for three, in x's type."""
    hi = x.astype(jnp.bfloat16).astype(x.dtype)
    if passes == 1:
        return (hi,)
    return hi, (x - hi).astype(jnp.bfloat16).astype(x.dtype)


def is_rounded(eqn) -> bool:
    """Whether the TPU's default precision reaches this product: an
    unpinned ``dot_general`` / ``conv_general_dilated`` of two f32
    operands (or float64 ones: a test's float64 reference of the same
    rounding, under ``jax.enable_x64``)."""
    return (eqn.primitive.name in PRODUCTS
            and eqn.params.get("precision") is None
            and all(v.aval.dtype in (jnp.float32, jnp.float64)
                    for v in eqn.invars))


def _sub_jaxpr(eqn):
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        sub = eqn.params.get(key)
        if sub is not None:
            return sub
    return None


def _carried(eqn):
    """The jaxprs the params of ``eqn`` hold (a loop's body and
    condition, a ``cond``'s branches, a scatter's combiner)."""
    kinds = (jcore.Jaxpr, jcore.ClosedJaxpr)
    for v in eqn.params.values():
        for x in (v if isinstance(v, tuple) else (v,)):
            if isinstance(x, kinds):
                yield _closed(x)[0]


def _holds_product(jaxpr) -> bool:
    return any(eqn.primitive.name in PRODUCTS
               or any(_holds_product(j) for j in _carried(eqn))
               for eqn in jaxpr.eqns)


def _closed(sub):
    if isinstance(sub, jcore.ClosedJaxpr):
        return sub.jaxpr, sub.consts
    return sub, ()


def _scan(eqn, args, passes):
    """``lax.scan`` again, its body evaluated with the same rounding."""
    p = eqn.params
    body, body_consts = _closed(p["jaxpr"])
    n_consts, n_carry = p["num_consts"], p["num_carry"]
    consts, carry = args[:n_consts], args[n_consts:n_consts + n_carry]

    def step(c, x):
        out = evaluate(body, body_consts, [*consts, *c, *x], passes)
        return out[:n_carry], out[n_carry:]

    carry, ys = lax.scan(step, list(carry), list(args[n_consts + n_carry:]),
                         length=p["length"], reverse=p["reverse"])
    return [*carry, *ys]


def _apply(eqn, args, passes):
    name = eqn.primitive.name
    if is_rounded(eqn):
        a, b = args
        ap, bp = parts(a, passes), parts(b, passes)
        return sum(eqn.primitive.bind(ap[i], bp[j], **eqn.params)
                   for i, j in PAIRS[passes])
    if name == "scan":
        return _scan(eqn, args, passes)
    if name in CALLS:
        jaxpr, consts = _closed(_sub_jaxpr(eqn))
        return evaluate(jaxpr, consts, args, passes)
    if any(_holds_product(j) for j in _carried(eqn)):
        raise NotImplementedError(
            f"{name} carries a product the evaluator does not enter")
    subfuns, params = eqn.primitive.get_bind_params(eqn.params)
    return eqn.primitive.bind(*subfuns, *args, **params)


def evaluate(jaxpr, consts, args, passes):
    """The outputs of ``jaxpr`` on ``args`` with the TPU's rounding of
    every default-precision f32 product."""
    env = {}

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]

    for v, x in zip(jaxpr.constvars, consts):
        env[v] = x
    for v, x in zip(jaxpr.invars, args):
        env[v] = x
    for eqn in jaxpr.eqns:
        out = _apply(eqn, [read(v) for v in eqn.invars], passes)
        if not eqn.primitive.multiple_results:
            out = [out]
        for v, x in zip(eqn.outvars, out):
            env[v] = x
    return [read(v) for v in jaxpr.outvars]


def tpu_eval(fn, passes: int):
    """``fn`` (array arguments only) as the TPU runs it at JAX's
    ``default`` (``passes`` 1) or ``high`` (3) matmul precision."""
    if passes not in PAIRS:
        raise ValueError(f"passes must be 1 or 3, got {passes!r}")

    def run(*args):
        closed, shape = jax.make_jaxpr(fn, return_shape=True)(*args)
        out = jax.jit(lambda *xs: evaluate(closed.jaxpr, closed.consts, xs,
                                           passes))(
            *jax.tree_util.tree_leaves(args))
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shape), out)
    return run


def products(fn, *args):
    """Every ``dot_general`` / ``conv_general_dilated`` in ``fn``'s jaxpr
    at ``args``, inside calls and scan bodies too: a list of (name,
    precision, operand dtypes, rounded by the TPU's default)."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in PRODUCTS:
                out.append((eqn.primitive.name, eqn.params.get("precision"),
                            tuple(str(v.aval.dtype) for v in eqn.invars),
                            is_rounded(eqn)))
            for sub in _carried(eqn):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out
