"""The two forms of the aggregation's backward (``ops/agg.py``), held on
the CPU through their plain twins:

- the frontier form (``agg_bwd_frontier``, twin ``agg_bwd_frontier_plain``),
  where entry e = b T + t is table row e, as the frontier forward's ids
  are: bit for bit ``agg_bwd_rows_plain`` over the CSR of the ``arange``,
  and through ``ConvAggregate`` (ids None) against ``jax.vjp`` of the JAX
  package's aggregation, alone and in the model's gradient;
- the table form's chunked order of sums (``agg_bwd_rows_plain``): a run
  of at most 128 entries summed in order as before, a longer one in
  chunks of 128 from its start, then the chunks' sums in chunk order.

The kernels themselves run only on the card:
``tests/test_torch_agg_backward_gpu.py`` holds them against these twins."""

import jax
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.models import pinsage as tp
from gcn_song_embeddings_tpu_torch.ops import agg
from gcn_song_embeddings_tpu_torch.train import trainer as ttrainer
from gcn_song_embeddings_tpu_torch.utils.checkpoint import params_from_numpy
from test_torch_agg_backward import (
    ATOL,
    ULP,
    _cot,
    _index_add_rows,
    _jax_grads,
    _pack_slope_bits,
)
from test_torch_train import (
    TRAJ,
    _batches,
    _cfgs,
    _jax_leaves,
    _jax_loss_fn,
    _jax_params,
    _port_leaves,
    _problem,
)
from torch_threads import one_torch_thread  # noqa: F401

WEIGHTS = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16}


def _frontier_inputs(b, t, hdim, residual, dtype=torch.float32, seed=0):
    """(nb_weights [b, t] of ``dtype``, dagg [b, hdim], the residual of
    the b t table rows: K2's projected rows as slabs or K3's bits of each
    entry), a quarter of the slopes or so negative, a node of zero
    weights."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.random((b, t)).astype(np.float32))
    w[1] = 0.0
    pre = torch.from_numpy(rng.normal(size=(b * t, hdim)).astype(np.float32)
                           + 0.5)
    res = (agg.rows_to_slabs(pre) if residual == "rows"
           else _pack_slope_bits(pre >= 0))
    dagg = torch.from_numpy(rng.normal(size=(b, hdim)).astype(np.float32))
    return w.to(dtype), dagg, res


@pytest.mark.parametrize("residual", ["rows", "bits"])
@pytest.mark.parametrize("passes", [None, 1, 3], ids=["p0", "p1", "p3"])
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_frontier_twin_is_the_table_twin_over_the_arange(weights, passes,
                                                         residual):
    """Each row named once: the frontier twin's S (its parts) and dbq
    equal ``agg_bwd_rows_plain`` over ``backward_csr_plain`` of the
    ``arange`` bit for bit, for f32 and 16-bit weights (their rounded
    denominator), passes 0, 1 and 3, K2's residual and K3's bits."""
    b, t, hdim = 23, 7, 136
    w, dagg, res = _frontier_inputs(b, t, hdim, residual, WEIGHTS[weights])
    ids = agg.identity_ids(torch.empty((b * t, 1)), w)
    assert torch.equal(ids.reshape(-1), torch.arange(b * t,
                                                     dtype=torch.int32))
    offsets, entries = agg.backward_csr_plain(ids, b * t)
    want, want_dbq = agg.agg_bwd_rows_plain(offsets, entries, w, dagg, res,
                                            passes)
    got, dbq = agg.agg_bwd_frontier_plain(w, dagg, res, passes)
    assert len(got) == len(want) == (2 if passes == 3 else 1)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert torch.equal(dbq, want_dbq)
    # the wrapper on CPU tensors is the twin, no launch counted
    before = (agg.bwd_frontier_launches, agg.bwd_launches, agg.csr_launches)
    again, dbq2 = agg.agg_bwd_frontier(w, dagg, res, passes)
    assert (agg.bwd_frontier_launches, agg.bwd_launches,
            agg.csr_launches) == before
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert torch.equal(dbq2, dbq)


def _in_order_rows(offsets, entries, w, dagg, res, passes=None):
    """The table form's order before chunks: each row's entries summed
    one at a time in CSR order from 0, however long the run."""
    n, hdim = offsets.numel() - 1, dagg.shape[1]
    t = w.shape[1]
    c = agg._bwd_weights(w)
    slope = (agg.slabs_to_rows(res, hdim) >= 0 if res.dim() == 3
             else agg.unpack_slope_bits(res, hdim))
    offsets, entries = offsets.long(), entries.long()
    sums = [dagg.new_zeros((n, hdim)) for _ in range(2 if passes == 3
                                                     else 1)]
    full = sums[0] if passes is None else torch.zeros_like(sums[0])
    counts = offsets[1:] - offsets[:-1]
    for k in range(int(counts.max())):
        rows = (counts > k).nonzero().squeeze(1)
        e = entries[offsets[rows] + k]
        term = agg._entry_terms(c, dagg, t, e,
                                slope[rows] if res.dim() == 3 else slope[e])
        agg._add_terms(sums, full, rows, term, passes)
    return sums, full.sum(dim=0)


def _runs_ids(runs, n_rows, b, t, seed):
    """ids [b, t] (b t = the entries) naming row i ``runs[i]`` times at
    random places, the rest uniform over the rows past them."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(len(runs), n_rows, b * t)
    places = rng.permutation(b * t)
    at = 0
    for row, k in enumerate(runs):
        flat[places[at:at + k]] = row
        at += k
    return torch.from_numpy(flat.reshape(b, t).astype(np.int32))


@pytest.mark.parametrize("passes", [None, 1, 3], ids=["p0", "p1", "p3"])
@pytest.mark.parametrize("residual", ["rows", "bits"])
def test_chunked_twin_keeps_the_order_of_runs_up_to_128(residual, passes):
    """Runs of 128, 127, 64 and 1 entries (and the rows' usual few): the
    chunked twin is today's order, every row's entries in CSR order from
    0, bit for bit."""
    b, t, n, hdim = 120, 5, 140, 12
    ids = _runs_ids((128, 127, 64, 1), n, b, t, seed=3)
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.random((b, t)).astype(np.float32))
    dagg = torch.from_numpy(rng.normal(size=(b, hdim)).astype(np.float32))
    pre = torch.from_numpy(rng.normal(size=(n, hdim)).astype(np.float32))
    res = (agg.rows_to_slabs(pre) if residual == "rows"
           else _pack_slope_bits(pre[ids.reshape(-1).long()] >= 0))
    offsets, entries = agg.backward_csr_plain(ids, n)
    assert int((offsets[1:] - offsets[:-1]).max()) == 128
    got, dbq = agg.agg_bwd_rows_plain(offsets, entries, w, dagg, res, passes)
    want, want_dbq = _in_order_rows(offsets, entries, w, dagg, res, passes)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert torch.equal(dbq, want_dbq)


def test_a_long_run_is_its_chunks_summed_in_order():
    """A row named 300 times: its S is 0 + (chunk 0's sum) + (chunk 1's)
    + (the last 44 entries'), each chunk summed in order from 0 in f32;
    here that differs from the sum of all 300 in order."""
    b, t = 100, 3
    ids = torch.zeros((b, t), dtype=torch.int32)
    rng = np.random.default_rng(5)
    w = torch.ones((b, t))
    dagg = torch.from_numpy((rng.normal(size=(b, 4)) * 10.0 ** rng.integers(
        -3, 4, (b, 1))).astype(np.float32))
    res = agg.rows_to_slabs(torch.ones((1, 4)))
    offsets, entries = agg.backward_csr_plain(ids, 1)
    (got,), _ = agg.agg_bwd_rows_plain(offsets, entries, w, dagg, res)
    terms = (1.0 / 3.0) * dagg.repeat_interleave(t, dim=0)
    want = torch.zeros(4)
    for lo in (0, 128, 256):
        part = torch.zeros(4)
        for row in terms[lo:lo + 128]:
            part = part + row
        want = want + part
    assert torch.equal(got[0], want)
    in_order, _ = _in_order_rows(offsets, entries, w, dagg, res)
    assert not torch.equal(in_order[0][0], want)


@pytest.mark.parametrize("passes", [None, 1, 3], ids=["f32", "x1", "x3"])
@pytest.mark.parametrize("run", [129, 300, 10_000])
def test_chunked_twin_is_the_index_add_formula_in_float64(run, passes):
    """Rows named 129, 300 and 10,000 times (the rest uniform): the
    chunked twin against the ``index_add_`` formula in float64, at
    ``test_twin_is_the_index_add_formula_in_float64``'s 1e-12."""
    t = 5
    b = max(60, -(-(run + 200) // t))
    n = 50
    ids = _runs_ids((run,), n, b, t, seed=run)
    rng = np.random.default_rng(run + 1)
    w = torch.from_numpy(rng.random((b, t)))
    w[1] = 0.0
    dagg = torch.from_numpy(rng.normal(size=(b, 20)))
    pre = torch.from_numpy(rng.normal(size=(n, 20)) + 0.5)
    offsets, entries = agg.backward_csr_plain(ids, n)
    assert int(offsets[1] - offsets[0]) == run
    parts, dbq = agg.agg_bwd_rows_plain(offsets, entries, w, dagg,
                                        agg.rows_to_slabs(pre), passes)
    want, want_dbq = _index_add_rows(ids, w, dagg, pre, passes)
    for got, ref in zip(parts, want):
        assert float((got - ref).abs().max()) <= 1e-12
    assert float((dbq - want_dbq).abs().max()) <= 1e-12


def _frontier_problem(b, t, din=24, hdim=20, seed=0):
    """h [b t, Din] (entry e's row e), nb_weights [b, t] (a zero row),
    Wq, bq: the frontier aggregation's inputs; with the ``arange`` ids
    for the JAX side."""
    rng = np.random.default_rng(seed)
    w = rng.random((b, t)).astype(np.float32)
    w[2] = 0.0
    return [rng.normal(size=(b * t, din)).astype(np.float32),
            np.arange(b * t, dtype=np.int32).reshape(b, t), w,
            (rng.normal(size=(hdim, din)) * .2).astype(np.float32),
            np.full(hdim, 0.1, np.float32)]


def _frontier_grads(arrays, dagg, mode, passes=None, dtype=None):
    """dh, dWq, dbq of ``ConvAggregate`` with ids None (the identity) on
    CPU tensors, counting the frontier twin's calls."""
    h, _, w, Wq, bq = (torch.from_numpy(a) for a in arrays)
    if dtype is not None:
        h, Wq = h.to(dtype), Wq.to(dtype)
    h, Wq, bq = (x.requires_grad_() for x in (h, Wq, bq))
    out = agg.ConvAggregate.apply(h, None, w, Wq, bq, mode, None, passes,
                                  True)
    return torch.autograd.grad(out, (h, Wq, bq), torch.from_numpy(dagg))


@pytest.mark.parametrize("mode", ["stream", "dma"])
def test_frontier_form_gradient_matches_jax_vjp(mode, monkeypatch):
    """``ConvAggregate`` told that entry e is row e (ids None) takes the
    frontier twin, no CSR, and its dh, dWq and dbq match ``jax.vjp`` of
    the JAX package's aggregation over the ``arange`` at atol 2e-5."""
    calls = []
    twin = agg.agg_bwd_frontier_plain
    monkeypatch.setattr(agg, "agg_bwd_frontier_plain",
                        lambda *a: calls.append(1) or twin(*a))
    monkeypatch.setattr(agg, "backward_csr_plain", None)
    arrays = _frontier_problem(14, 10, seed=2)
    dagg = _cot(14, 20)
    got = _frontier_grads(arrays, dagg, mode)
    assert calls == [1]
    for g, want in zip(got, _jax_grads(arrays, dagg)):
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_16bit_frontier_form_matches_jax_vjp(dtype):
    """A bf16 or f16 table and Wq through the frontier form: dbq at atol
    2e-5, dh and dWq (in the table's type) within half an ulp of JAX's
    f32 gradient of the same 16-bit values upcast (plus 2e-5)."""
    arrays = _frontier_problem(12, 6, seed=4)
    for i in (0, 3):
        arrays[i] = torch.from_numpy(arrays[i]).to(dtype).float().numpy()
    dagg = _cot(12, 20)
    got = _frontier_grads(arrays, dagg, "dma", dtype=dtype)
    want = _jax_grads(arrays, dagg)
    assert [g.dtype for g in got] == [dtype, dtype, torch.float32]
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=ATOL)
    for g, r in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.float().numpy(), r, rtol=ULP[dtype],
                                   atol=ATOL)


@pytest.mark.parametrize("passes", [1, 3])
def test_passes_frontier_form_is_the_table_forms_gradient(passes):
    """In one or three bf16 passes the frontier form's gradients equal
    the table form's over the ``arange`` ids bit for bit (the same
    sums)."""
    arrays = _frontier_problem(9, 8, seed=6)
    dagg = _cot(9, 20)
    got = _frontier_grads(arrays, dagg, "stream", passes)
    h, ids, w, Wq, bq = (torch.from_numpy(a) for a in arrays)
    h, Wq, bq = (x.requires_grad_() for x in (h, Wq, bq))
    out = agg.ConvAggregate.apply(h, ids, w, Wq, bq, "stream", None, passes,
                                  True)
    want = torch.autograd.grad(out, (h, Wq, bq), torch.from_numpy(dagg))
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_model_gradient_through_forward_with_gather_takes_the_frontier_form(
        monkeypatch):
    """The frontier train step's loss and every gradient with each
    aggregation through ``ConvAggregate`` (as CUDA tensors go): every
    conv of ``forward_with_gather`` states the identity, so each backward
    runs the frontier twin and builds no CSR, and the gradients match
    ``jax.value_and_grad`` of the JAX package's frontier forward (the
    tolerances of ``tests/test_torch_train.py``)."""
    seen = []

    def through_the_function(h, nb, w, Wq, bq, mode="stream",
                             block_rows=None):
        seen.append(nb)
        return agg.ConvAggregate.apply(
            h, None if nb is None else nb.to(torch.int32).contiguous(),
            w.contiguous(), Wq, bq, mode, block_rows, None, True)

    calls = []
    twin = agg.agg_bwd_frontier_plain
    monkeypatch.setattr(tp, "conv_aggregate", through_the_function)
    monkeypatch.setattr(agg, "agg_bwd_frontier_plain",
                        lambda *a: calls.append(1) or twin(*a))
    monkeypatch.setattr(agg, "backward_csr_plain", None)
    feats, w, nodes = _problem()
    batch = _batches(1)[0]
    jparams = _jax_params()
    tcfg, mcfg, _ = _cfgs()
    want_loss, want_grads = jax.value_and_grad(
        _jax_loss_fn(feats, w, nodes, batch, tcfg.margin))(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tables = ttrainer.TrainTables.build(feats, w, nodes, mcfg.T)
    loss, _ = ttrainer.triple_loss(params, tables, torch.from_numpy(batch),
                                   tcfg, mcfg, False)
    grads = torch.autograd.grad(loss, _port_leaves(params))
    assert seen == [None] * mcfg.n_layers
    assert calls == [1] * mcfg.n_layers
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6)
    for g, want in zip(grads, _jax_leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TRAJ)


def test_the_identity_needs_b_t_table_rows():
    w = torch.ones((3, 4))
    with pytest.raises(ValueError, match="B T = 12 rows"):
        agg.identity_ids(torch.zeros((11, 2)), w)
    h = torch.zeros((12, 8))
    out = agg.conv_aggregate(h, None, w, torch.zeros((4, 8)), torch.zeros(4))
    assert out.shape == (3, 4)
