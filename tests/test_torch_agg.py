"""Port's aggregation (the plain version of K2 and K3) and its backward
vs the JAX package's XLA path, its autodiff and its Pallas kernels in
interpret mode, at the JAX suite's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.ops.pallas_agg import (
    conv_aggregate as j_conv_aggregate,
    dma_gather_aggregate,
    fused_gather_aggregate,
)
from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg
import torch_agg_entry_cases as entry_cases

ATOL = 2e-5  # tests/test_pallas_agg.py


def _problem(b, t=3, n=1000, din=256, h=128, seed=0, zero_row=None):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(n, din)).astype(np.float32),
              rng.integers(0, n, (b, t)).astype(np.int32),
              rng.random((b, t)).astype(np.float32),
              (rng.normal(size=(h, din)) * .05).astype(np.float32),
              np.full(h, 0.3, np.float32)]
    if zero_row is not None:
        arrays[2][zero_row] = 0.0          # all-zero neighborhood guard
    return arrays


@pytest.mark.parametrize("b,zero_row", [(300, None), (65, 3)])
def test_plain_aggregate_matches_jax_paths(b, zero_row):
    arrays = _problem(b, zero_row=zero_row)
    before = agg.launches
    got = agg.conv_aggregate(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert agg.launches == before          # CPU tensors: plain version
    assert got.shape == (b, 128)
    jax_args = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(
        got, np.asarray(j_conv_aggregate(*jax_args)), atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(fused_gather_aggregate(*jax_args, interpret=True)),
        atol=ATOL)
    if zero_row is not None:
        # denominator 1: the row is the plain (unweighted) zero sum
        np.testing.assert_array_equal(got[zero_row], 0.0)


def test_plain_aggregate_at_slice_width():
    """T=10 (recommended model), Din=H=512, as embed_all's layer 0."""
    arrays = _problem(40, t=10, n=300, din=512, h=512, seed=4)
    got = agg.conv_aggregate_plain(*(torch.from_numpy(a) for a in arrays))
    want = j_conv_aggregate(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("b,zero_row", [(600, None), (130, 3)])
def test_dma_mode_matches_jax_dma_kernel(b, zero_row):
    """K3's contract at tests/test_pallas_agg.py's shapes: b=600 is three
    256-node tiles on the TPU, b=130 a padded one with a zero-weight row.
    On the CPU the "dma" mode runs the plain version."""
    arrays = _problem(b, zero_row=zero_row)
    before = (agg.launches, dma_agg.launches)
    got = agg.conv_aggregate(*(torch.from_numpy(a) for a in arrays),
                             mode="dma").numpy()
    assert (agg.launches, dma_agg.launches) == before
    assert got.shape == (b, 128)
    want = dma_gather_aggregate(*(jnp.asarray(a) for a in arrays),
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    if zero_row is not None:
        np.testing.assert_array_equal(got[zero_row], 0.0)


def test_unknown_mode_is_refused():
    arrays = [torch.from_numpy(a) for a in _problem(5)]
    with pytest.raises(ValueError, match="mode"):
        agg.conv_aggregate(*arrays, mode="pallas")


@pytest.mark.parametrize("call,match", [c[1:] for c in entry_cases.CASES],
                         ids=[c[0] for c in entry_cases.CASES])
def test_kernel_entries_refuse_what_they_cannot_take(call, match):
    """K2's kernel entries check their tensors as conv_aggregate_cuda
    does, and refuse CPU tensors rather than pass their pointers on."""
    before = dict(agg.kernel_launches)
    with pytest.raises(ValueError, match=match):
        call(entry_cases.tensors("cpu"))
    assert agg.kernel_launches == before


def test_backward_gradcheck_float64():
    """ConvAggregate's hand-written backward against finite differences,
    in float64 with the plain forward (CPU tensors)."""
    rng = np.random.default_rng(5)
    n, b, t, din, hdim = 12, 5, 3, 4, 3
    h = torch.tensor(rng.normal(size=(n, din)), requires_grad=True)
    nb = torch.tensor(rng.integers(0, n, (b, t)), dtype=torch.int32)
    w = torch.tensor(rng.random((b, t)))
    w[2] = 0.0                                # all-zero neighborhood
    Wq = torch.tensor(rng.normal(size=(hdim, din)), requires_grad=True)
    bq = torch.tensor(rng.normal(size=hdim) * 0.1, requires_grad=True)
    for mode in ("stream", "dma"):
        assert torch.autograd.gradcheck(
            lambda h, Wq, bq: agg.ConvAggregate.apply(h, nb, w, Wq, bq,
                                                      mode),
            (h, Wq, bq))


@pytest.mark.parametrize("b,t,din,hdim,zero_row", [
    (65, 3, 256, 128, 3), (40, 10, 128, 512, None)])
def test_backward_matches_jax_vjp(b, t, din, hdim, zero_row):
    """dh, dWq and dbq of ConvAggregate vs jax.vjp of the JAX package's
    XLA aggregation (its train-step gradient), atol 2e-5."""
    arrays = _problem(b, t=t, n=300, din=din, h=hdim, seed=6,
                      zero_row=zero_row)
    cot = np.random.default_rng(7).normal(size=(b, hdim)).astype(np.float32)
    h, nb, w, Wq, bq = (torch.from_numpy(a) for a in arrays)
    h, Wq, bq = (x.requires_grad_() for x in (h, Wq, bq))
    out = agg.ConvAggregate.apply(h, nb, w, Wq, bq, "dma")
    got = torch.autograd.grad(out, (h, Wq, bq), torch.from_numpy(cot))
    jh, jnb, jw, jWq, jbq = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda h, Wq, bq: j_conv_aggregate(h, jnb, jw, Wq, bq),
                     jh, jWq, jbq)
    for g, want in zip(got, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=ATOL)
    # and the plain version's own autograd gives the same gradient
    ref = torch.autograd.grad(agg.conv_aggregate_plain(h, nb, w, Wq, bq),
                              (h, Wq, bq), torch.from_numpy(cot))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL)


@pytest.mark.parametrize("b,t,din,hdim,zero_row", [
    (65, 3, 256, 128, 3), (40, 10, 512, 512, None)])
def test_k2_two_phase_plain_matches_jax_paths(b, t, din, hdim, zero_row):
    """K2's plain phases, the table projected once (``project_table_plain``)
    and then gathered (``gather_mean_plain``), against the JAX package's
    Pallas kernel in interpret mode and its XLA path: leaky_relu acts per
    projected row before the weighting, so the composition is the same
    function."""
    arrays = _problem(b, t=t, n=300, din=din, h=hdim, seed=8,
                      zero_row=zero_row)
    h, nb, w, Wq, bq = (torch.from_numpy(a) for a in arrays)
    proj = agg.project_table_plain(h, Wq, bq)
    assert proj.shape == (300, hdim)
    got = agg.gather_mean_plain(proj, nb, w).numpy()
    jax_args = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(
        got, np.asarray(fused_gather_aggregate(*jax_args, interpret=True)),
        atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(j_conv_aggregate(*jax_args)), atol=ATOL)
    if zero_row is not None:
        np.testing.assert_array_equal(got[zero_row], 0.0)


def _xavier(hdim, din, seed):
    rng = np.random.default_rng(seed)
    limit = np.sqrt(6.0 / (hdim + din))
    return rng.uniform(-limit, limit, (hdim, din)).astype(np.float32)


def test_tf32_split_parts_are_tf32_and_sum_back():
    """big and small keep 10 mantissa bits (the low 13 bits are 0, what
    cvt.rna.tf32.f32 leaves), and big + small gives x back within 2^-22
    of |x|."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(300, 77)).astype(np.float32) * 10.0 ** np.arange(-3, 4)
        .repeat(11)[None, :77].astype(np.float32))
    big, small = agg.tf32_split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -22
    # ties round away from zero, as cvt.rna does
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert agg.tf32_round(tie).tolist() == [1.0 + 2.0 ** -10,
                                            -(1.0 + 2.0 ** -10)]


def test_three_tf32_passes_are_f32_accurate_and_one_is_not():
    """The 3xTF32 product (small x big + big x small + big x big, each
    product exact in f32, sums in f32) against float64 at Din = H = 512,
    Gaussian rows and Xavier Wq: within 1e-5.  A single TF32 pass errs
    above 1e-4 -- why K2 and K3 take three."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(1000, 512)).astype(np.float32))
    b = torch.from_numpy(_xavier(512, 512, 3))
    want = a.double() @ b.double().t()
    (ab, as_), (bb, bs) = agg.tf32_split(a), agg.tf32_split(b)
    three = as_ @ bb.t() + ab @ bs.t() + ab @ bb.t()
    one = ab @ bb.t()
    assert float((three.double() - want).abs().max()) <= 1e-5
    assert float((one.double() - want).abs().max()) > 1e-4


def test_wq_tile_layout_is_the_swizzled_one():
    """``tile_wq_plain``: element (n, k) of Wq sits in tile (n // 128,
    k // 32), row n % 128, 16-byte chunk (k % 32 // 4) ^ (n % 8), zeros
    past H and Din; ``slabs_to_rows`` undoes the projection's slabs."""
    x = torch.arange(100 * 36, dtype=torch.float32).reshape(100, 36) + 1
    t = agg.tile_wq_plain(x)
    assert t.shape == (1, 2, 128, 32)
    n, k = torch.meshgrid(torch.arange(100), torch.arange(36),
                          indexing="ij")
    chunk = (k % 32 // 4) ^ (n % 8)
    assert torch.equal(t[n // 128, k // 32, n % 128, chunk * 4 + k % 4], x)
    assert int((t != 0).sum()) == x.numel()
    slabs = torch.arange(3 * 5 * 64, dtype=torch.float32).reshape(3, 5, 64)
    rows = agg.slabs_to_rows(slabs, 150)
    assert rows.shape == (5, 150)
    assert torch.equal(rows[2, 70], slabs[1, 2, 6])
