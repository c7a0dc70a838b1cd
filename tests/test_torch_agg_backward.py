"""The aggregation's backward in table form (``ops/agg.py``
``ConvAggregate.backward``): the plain twin of the backward kernel
(``agg_bwd_rows_plain``, which CPU tensors run) against ``jax.vjp`` of
the JAX package's XLA aggregation, against the ``index_add_`` formula it
replaced in float64, and the CSR inverse of the ids it sums over.

The kernel itself (``csrc/agg_bwd.cu``) runs only on the card:
``tests/test_torch_agg_backward_gpu.py`` holds it against this twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.ops.pallas_agg import (
    conv_aggregate as j_conv_aggregate,
)
from gcn_song_embeddings_tpu_torch.models import pinsage as tp
from gcn_song_embeddings_tpu_torch.ops import agg
from test_torch_precision import _jax_aggregate, _q_einsum
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5  # tests/test_pallas_agg.py, tests/test_torch_agg.py
ULP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}  # half an ulp
BF = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _pack_slope_bits(slope):
    """bool [E, H] -> K3's slope residual, int32 [E, ``slope_words(H)``]:
    the bit of ``agg._slope_places`` of column c is ``slope[:, c]``, the
    others 0 (the kernel stores q >= 0 there for its zero-padded columns
    past H, which nothing reads)."""
    e, hdim = slope.shape
    word, bit = agg._slope_places(hdim, slope.device)
    packed = torch.zeros((e, agg.slope_words(hdim)), dtype=torch.int64,
                         device=slope.device)
    packed.index_add_(1, word, slope.to(torch.int64) << bit)
    return (packed - (packed >> 31) * (1 << 32)).to(torch.int32)


def _ids(kind, rng, n, b, t):
    """nb [b, t] int32 of a table of n rows: "full" (b = n nodes, each
    row named about t times), "frontier" (m + arange(m t), the first m
    rows never named), "sparse" (most rows never named)."""
    if kind == "frontier":
        return (b + np.arange(b * t, dtype=np.int32)).reshape(b, t)
    return rng.integers(0, n, (b, t)).astype(np.int32)


def _problem(kind, b, t, n, din=24, hdim=20, seed=0, zero_row=None):
    rng = np.random.default_rng(seed)
    w = rng.random((b, t)).astype(np.float32)
    if zero_row is not None:
        w[zero_row] = 0.0                     # the all-zero guard
    return [rng.normal(size=(n, din)).astype(np.float32),
            _ids(kind, rng, n, b, t), w,
            (rng.normal(size=(hdim, din)) * .2).astype(np.float32),
            np.full(hdim, 0.1, np.float32)]


def _cot(b, hdim, seed=9):
    return np.random.default_rng(seed).normal(size=(b, hdim)).astype(
        np.float32)


def _jax_grads(arrays, dagg, fn=j_conv_aggregate):
    h, nb, w, Wq, bq = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda h_, Wq_, bq_: fn(h_, nb, w, Wq_, bq_), h, Wq, bq)
    return [np.asarray(g) for g in vjp(jnp.asarray(dagg))]


def _port_grads(arrays, dagg, mode, passes=None, dtype=None):
    h, nb, w, Wq, bq = (torch.from_numpy(a) for a in arrays)
    if dtype is not None:
        h, Wq = h.to(dtype), Wq.to(dtype)
    h, Wq, bq = (x.requires_grad_() for x in (h, Wq, bq))
    out = agg.ConvAggregate.apply(h, nb, w, Wq, bq, mode, None, passes,
                                  True)
    return torch.autograd.grad(out, (h, Wq, bq), torch.from_numpy(dagg))


CASES = {  # kind, b, t, n, zero_row
    "fullgraph": ("full", 120, 10, 120, None),
    "frontier": ("frontier", 12, 10, 132, None),
    "rows_never_named": ("sparse", 15, 3, 400, None),
    "zero_weight_row": ("full", 60, 4, 60, 3),
}


@pytest.mark.parametrize("mode", ["stream", "dma"])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_gradient_matches_jax_vjp(case, mode):
    """dh, dWq and dbq of ``ConvAggregate`` on CPU tensors (the twin over
    ``backward_csr``) against ``jax.vjp`` of the JAX package's XLA
    aggregation, atol 2e-5."""
    kind, b, t, n, zero_row = CASES[case]
    arrays = _problem(kind, b, t, n, seed=len(case), zero_row=zero_row)
    dagg = _cot(b, 20)
    before = (agg.bwd_launches, dict(agg.backward_launches))
    got = _port_grads(arrays, dagg, mode)
    assert (agg.bwd_launches, agg.backward_launches) == before
    for g, want in zip(got, _jax_grads(arrays, dagg)):
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL)
    if kind != "full":
        named = np.zeros(n, bool)
        named[arrays[1].reshape(-1)] = True
        assert not got[0][torch.from_numpy(~named)].any()


def test_twin_through_aggregates_slicing_past_t64(monkeypatch):
    """T = 70 in mode "dma": ``aggregate`` cuts the neighbor columns into
    slices of at most 64, each through ``ConvAggregate`` (as CUDA tensors
    would go), and the gradient of the whole matches ``jax.vjp`` of the
    unsliced XLA aggregation."""
    calls = []

    def through_the_function(h, nb, w, Wq, bq, mode="stream",
                             block_rows=None):
        calls.append(nb.shape[1])
        return agg.ConvAggregate.apply(h, nb.to(torch.int32).contiguous(),
                                       w.contiguous(), Wq, bq, mode,
                                       block_rows, None, True)

    monkeypatch.setattr(tp, "conv_aggregate", through_the_function)
    arrays = _problem("full", 30, 70, 90, seed=3, zero_row=2)
    dagg = _cot(30, 20)
    h, nb, w, Wq, bq = (torch.from_numpy(a) for a in arrays)
    h, Wq, bq = (x.requires_grad_() for x in (h, Wq, bq))
    out = tp.aggregate(h, nb, w, Wq, bq, mode="dma")
    got = torch.autograd.grad(out, (h, Wq, bq), torch.from_numpy(dagg))
    assert calls == [64, 6]
    for g, want in zip(got, _jax_grads(arrays, dagg)):
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("case", ["fullgraph", "frontier"])
def test_16bit_twin_gradient_matches_jax_vjp(dtype, case):
    """A bf16 or f16 table and Wq: the twin's f32 row sums against
    ``jax.vjp`` of the XLA aggregation of the same 16-bit values upcast
    (the port's products of 16-bit operands are exact in f32): dbq (f32)
    at atol 2e-5; dh and dWq, returned in the table's type, each the f32
    gradient rounded once, so within half an ulp of the type of JAX's f32
    gradient (plus 2e-5)."""
    kind, b, t, n, zero_row = CASES[case]
    arrays = _problem(kind, b, t, n, seed=5, zero_row=zero_row)
    for i in (0, 3):
        arrays[i] = torch.from_numpy(arrays[i]).to(dtype).float().numpy()
    dagg = _cot(b, 20)
    got = _port_grads(arrays, dagg, "dma", dtype=dtype)
    want = _jax_grads(arrays, dagg)
    assert [g.dtype for g in got] == [dtype, dtype, torch.float32]
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=ATOL)
    for g, r in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.float().numpy(), r, rtol=ULP[dtype],
                                   atol=ATOL)
    # and JAX's own 16-bit path (a 16-bit scatter-add for dh) stays within
    # a few ulps of it
    jarrays = [jnp.asarray(a).astype(BF[dtype]) if i in (0, 3)
               else jnp.asarray(a) for i, a in enumerate(arrays)]
    _, vjp = jax.vjp(lambda h_, Wq_: j_conv_aggregate(
        h_, jarrays[1], jarrays[2], Wq_, jarrays[4]), jarrays[0], jarrays[3])
    for g, r in zip(got[:2], vjp(jnp.asarray(dagg))):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r,
                                   atol=16 * ULP[dtype] * np.abs(r).max())


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("case", ["fullgraph", "frontier"])
def test_passes_twin_gradient_matches_jax_vjp(passes, case):
    """Under the precision policy (an f32 table in one or three bf16
    passes) the twin rounds each term as the TPU's backward dots round
    their cotangent: against ``jax.vjp`` of the same function with the
    TPU's rounded Q einsum (``tests/test_torch_precision.py``'s
    reference), within 1e-5 of each gradient's largest entry (as there:
    the same sums in another order)."""
    kind, b, t, n, zero_row = CASES[case]
    arrays = _problem(kind, b, t, n, seed=7, zero_row=zero_row)
    dagg = _cot(b, 20)
    got = _port_grads(arrays, dagg, "stream", passes)
    want = _jax_grads(arrays, dagg, lambda *a: _jax_aggregate(
        *a, _q_einsum(passes)))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt,
                                   atol=1e-5 * np.abs(wnt).max())


def _float64_rows(kind, b, t, n, hdim=20, seed=0):
    """Float64 inputs of the row sums: (nb, w [B, T], dagg [B, H], pre
    [N, H]) with a quarter of the pre-activations negative or so."""
    rng = np.random.default_rng(seed)
    nb = torch.from_numpy(_ids(kind, rng, n, b, t))
    w = torch.from_numpy(rng.random((b, t)))
    w[1] = 0.0
    dagg = torch.from_numpy(rng.normal(size=(b, hdim)))
    pre = torch.from_numpy(rng.normal(size=(n, hdim)) + 0.5)
    return nb, w, dagg, pre


def _index_add_rows(nb, w, dagg, pre, passes=None):
    """The backward's row sums by another route: every entry's row
    gradient materialized and ``index_add_``-ed onto its table row."""
    t = nb.shape[1]
    ids = nb.reshape(-1).long()
    c = (w / agg._denominator(w)).reshape(-1)
    dq = c[:, None] * dagg.repeat_interleave(t, dim=0)
    dpre = torch.where(pre[ids] >= 0.0, dq, 0.01 * dq)
    parts = (dpre,) if passes is None else agg._parts(dpre, passes)
    return ([torch.zeros_like(pre).index_add_(0, ids, d) for d in parts],
            dpre.sum(dim=0))


@pytest.mark.parametrize("passes", [None, 1, 3], ids=["f32", "x1", "x3"])
@pytest.mark.parametrize("residual", ["rows", "bits"])
@pytest.mark.parametrize("kind", ["full", "frontier", "sparse"])
def test_twin_is_the_index_add_formula_in_float64(kind, residual, passes):
    """The twin's sums, in their sorted order, against the ``index_add_``
    formula in float64, to 1e-12: the slopes read from K2's residual
    (projected rows as slabs, one slope a table row) or K3's (the bits of
    each entry)."""
    b, t, n = 40, 5, 240
    nb, w, dagg, pre = _float64_rows(kind, b, t, n, seed=len(kind))
    offsets, entries = agg.backward_csr(nb, n)
    res = (agg.rows_to_slabs(pre) if residual == "rows" else
           _pack_slope_bits(pre[nb.reshape(-1).long()] >= 0))
    parts, dbq = agg.agg_bwd_rows(offsets, entries, w, dagg, res, passes)
    want, want_dbq = _index_add_rows(nb, w, dagg, pre, passes)
    assert len(parts) == len(want)
    for got, ref in zip(parts, want):
        assert float((got - ref).abs().max()) <= 1e-12
    assert float((dbq - want_dbq).abs().max()) <= 1e-12


def test_twin_sums_each_rows_entries_in_csr_order():
    """One row named by three entries whose f32 sum depends on the order:
    the twin adds them as ``entries`` lists them (ascending), from 0."""
    nb = torch.tensor([[0], [0], [0]], dtype=torch.int32)
    dagg = torch.tensor([[1.0], [1e8], [-1e8]]).repeat(1, 4)
    w = torch.ones((3, 1))
    offsets, entries = agg.backward_csr(nb, 1)
    assert entries.tolist() == [0, 1, 2]
    pre = torch.ones((1, 4))
    (s,), _ = agg.agg_bwd_rows_plain(offsets, entries, w, dagg,
                                     agg.rows_to_slabs(pre))
    # in f32 (1 + 1e8) - 1e8 is 0; the order 1e8, -1e8, 1 would give 1
    assert s.tolist() == [[0.0] * 4]


def test_twin_takes_the_denominator_in_order_and_rounded_to_16_bits():
    """c = w / den with den summed w[:, 0] + w[:, 1] + ... from 0 (the
    kernel's order), of 16-bit weights rounded to their type as the
    forward's K2 gather rounds it, 1 for an all-zero row."""
    w = torch.tensor([[1.0, 2.0 ** -9, 0.0], [0.0, 0.0, 0.0],
                      [0.5, 0.25, 0.125]])
    den = agg._bwd_denominators(w, False, w.dtype)
    assert den.tolist() == [1.0 + 2.0 ** -9, 1.0, 0.875]
    for dtype in (torch.bfloat16, torch.float16):
        den16 = agg._bwd_denominators(w, True, dtype)
        assert torch.equal(den16, torch.where(
            den == 1.0, den, den.to(dtype).float()))
    # bf16 has 8 significant bits: 1 + 2^-9 rounds to 1
    assert agg._bwd_denominators(w, True, torch.bfloat16)[0] == 1.0
    nb = torch.tensor([[0, 1, 2], [0, 1, 2], [2, 1, 0]], dtype=torch.int32)
    offsets, entries = agg.backward_csr(nb, 3)
    dagg = torch.ones((3, 4))
    (s,), dbq = agg.agg_bwd_rows_plain(
        offsets, entries, w.to(torch.bfloat16), dagg,
        agg.rows_to_slabs(torch.ones((3, 4))))
    c = [[1.0, 2.0 ** -9, 0.0], [0.0, 0.0, 0.0],
         [0.5 / 0.875, 0.25 / 0.875, 0.125 / 0.875]]
    want = torch.tensor([c[0][0] + c[2][2], c[0][1] + c[2][1],
                         c[0][2] + c[2][0]])
    assert torch.allclose(s[:, 0], want, rtol=1e-6)


def test_csr_is_the_same_on_every_run():
    rng = np.random.default_rng(1)
    nb = torch.from_numpy(rng.integers(0, 50, (80, 7)).astype(np.int32))
    first = agg.backward_csr(nb, 60)
    second = agg.backward_csr(nb.clone(), 60)
    for a, b in zip(first, second):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    offsets, entries = first
    assert offsets[0] == 0 and offsets[-1] == nb.numel()
    assert torch.equal(offsets[1:] - offsets[:-1],
                       torch.bincount(nb.reshape(-1).long(), minlength=60)
                       .to(torch.int32))
    for r in range(60):
        run = entries[offsets[r]:offsets[r + 1]]
        assert torch.equal(run, run.sort().values)
        assert (nb.reshape(-1)[run.long()] == r).all()


def test_csr_of_permuted_duplicate_ids():
    """The same ids in another order (duplicates permuted among the
    entries): the same offsets, and each row lists the permuted positions
    of its entries, ascending."""
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 9, (30, 4)).astype(np.int32))
    perm = torch.from_numpy(rng.permutation(ids.numel()))
    permuted = ids.reshape(-1)[perm].reshape(30, 4)
    offsets, entries = agg.backward_csr(ids, 9)
    p_offsets, p_entries = agg.backward_csr(permuted, 9)
    assert torch.equal(offsets, p_offsets)
    for r in range(9):
        run = p_entries[p_offsets[r]:p_offsets[r + 1]].long()
        assert torch.equal(run, run.sort().values)
        assert torch.equal(perm[run].sort().values,
                           entries[offsets[r]:offsets[r + 1]].long())


def test_slope_bits_round_trip():
    """K3's residual layout, its accumulator fragment's: column c at bit
    2 ((c % 128) / 8) + c % 2 of word 4 (c / 128) + (c % 8) / 2, four
    words a 128-column tile, the bits of no column 0."""
    rng = np.random.default_rng(3)
    slope = torch.from_numpy(rng.random((17, 200)) < 0.5)
    bits = _pack_slope_bits(slope)
    assert bits.dtype == torch.int32 and bits.shape == (17, 8)
    assert agg.slope_words(200) == 8 and agg.slope_words(512) == 16
    assert torch.equal(agg.unpack_slope_bits(bits, 200), slope)
    assert not (bits[:, 4:] & ~((1 << 18) - 1)).any()   # columns 200..255
    one = torch.zeros((1, 256), dtype=torch.bool)
    one[0, 130] = one[0, 127] = True      # word 5 bit 0; word 3 bit 31
    assert _pack_slope_bits(one).tolist() == [[0, 0, 0, -2 ** 31,
                                              0, 1, 0, 0]]


def test_residual_slopes_read_both_forms():
    rng = np.random.default_rng(4)
    pre = torch.from_numpy(rng.normal(size=(30, 70)).astype(np.float32))
    nb = torch.from_numpy(rng.integers(0, 30, (8, 3)).astype(np.int32))
    want = pre[nb.reshape(-1).long()] >= 0
    assert torch.equal(agg.residual_slopes(agg.rows_to_slabs(pre), nb, 70),
                       want)
    assert torch.equal(agg.residual_slopes(_pack_slope_bits(want), nb,
                                           70), want)
    assert torch.equal(agg.slabs_to_rows(agg.rows_to_slabs(pre), 70), pre)


def test_wrapper_on_cpu_tensors_runs_the_twin():
    """``agg_bwd_rows`` takes its plain twin only for CPU tensors (no
    launch counted); a CUDA tensor would launch the kernel or raise."""
    nb, w, dagg, pre = _float64_rows("full", 12, 3, 12, seed=5)
    offsets, entries = agg.backward_csr(nb, 12)
    res = agg.rows_to_slabs(pre)
    before = (agg.bwd_launches, agg.csr_launches)
    got = agg.agg_bwd_rows(offsets, entries, w, dagg, res, 3)
    want = agg.agg_bwd_rows_plain(offsets, entries, w, dagg, res, 3)
    assert (agg.bwd_launches, agg.csr_launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])


def test_backward_of_no_nodes_is_zero():
    """B = 0 nodes: no entry names a row, every gradient is 0."""
    h, nb, w, Wq, bq = (torch.from_numpy(a)
                        for a in _problem("full", 0, 3, 10))
    h, Wq, bq = (x.requires_grad_() for x in (h, Wq, bq))
    out = agg.ConvAggregate.apply(h, nb, w, Wq, bq, "stream", None, None,
                                  True)
    assert out.shape == (0, 20)
    for g in torch.autograd.grad(out.sum(), (h, Wq, bq)):
        assert not g.any()
