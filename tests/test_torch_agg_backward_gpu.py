"""The aggregation's backward kernel (``csrc/agg_bwd.cu``) and the
forward's slope residual on the card: the kernel against its plain twin
(``agg.agg_bwd_rows_plain``) for every form (f32, bf16, f16, bf16x1,
bf16x3) and both modes, bit for bit; two runs of the whole gradient equal
bit for bit; K3 with its slope flag on and off giving the same outputs;
the stored slopes equal to q >= 0 of the plain forward in float64 but for
entries within BRANCH_ATOL of 0; and ``ConvAggregate``'s gradient against
float64 autograd through the plain version at those slopes.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_agg_backward_gpu.py
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.ops import agg

pytestmark = pytest.mark.gpu

GRAD_RTOL = 1e-3    # chip_smoke.py's bar for the aggregation's backward
BRANCH_ATOL = 1e-5  # f32 rounding of a Din-term sum near 0 (chip_smoke.py)
# table type and bf16 passes of each form
FORMS = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
         "f16": (torch.float16, None), "bf16x1": (torch.float32, 1),
         "bf16x3": (torch.float32, 3)}
# (kind, B, T, N, Din, H): a full-graph layer (ids repeat, every row named
# about T times) and a frontier one (node i's rows m + i T .., the first
# m never named), H 200 leaving ragged 32-, 64- and 128-column edges
SHAPES = {"fullgraph": ("full", 700, 10, 700, 128, 512),
          "frontier": ("frontier", 90, 10, 990, 64, 200)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _args(dev, shape, form, seed=0):
    kind, b, t, n, din, hdim = SHAPES[shape]
    rng = np.random.default_rng(seed)
    ids = ((b + np.arange(b * t)).reshape(b, t) if kind == "frontier"
           else rng.integers(0, n, (b, t))).astype(np.int32)
    w = rng.random((b, t)).astype(np.float32)
    w[3] = 0.0                                # the all-zero guard
    dtype, passes = FORMS[form]
    h, nb, w, Wq, bq = (torch.as_tensor(a, device=dev) for a in (
        rng.normal(size=(n, din)).astype(np.float32), ids, w,
        (rng.normal(size=(hdim, din)) * 0.1).astype(np.float32),
        np.full(hdim, 0.1, np.float32)))
    return (h.to(dtype), nb, w, Wq.to(dtype), bq), passes


def _rows_inputs(args, passes, mode, dagg):
    """The backward kernel's inputs as ``ConvAggregate.backward`` makes
    them: the CSR of the ids, the weights, the incoming gradient and the
    forward's residual."""
    h, nb, w, Wq, bq = args
    _, res = agg.conv_aggregate_cuda(h, nb, w, Wq, bq, mode, None, passes,
                                     residual=True)
    offsets, entries = agg.backward_csr(nb, h.shape[0])
    return offsets, entries, w, dagg, res, passes


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", ["stream", "dma"])
@pytest.mark.parametrize("form", list(FORMS))
def test_kernel_is_its_twin_bit_for_bit(cuda, form, mode, shape):
    """S (or its bf16 parts) of the kernel equal to the twin's bits (the
    same order of sums); dbq (per-block partials, then one sum) within
    1e-6 of the sum of |S| per column; rows never named all 0."""
    args, passes = _args(cuda, shape, form)
    dagg = torch.randn((args[1].shape[0], args[3].shape[0]), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(2))
    inputs = _rows_inputs(args, passes, mode, dagg)
    before = agg.bwd_launches
    parts, dbq = agg.agg_bwd_rows(*inputs)
    torch.cuda.synchronize()
    assert agg.bwd_launches == before + 1
    want, want_dbq = agg.agg_bwd_rows_plain(*inputs)
    assert len(parts) == len(want) == (2 if passes == 3 else 1)
    for got, ref in zip(parts, want):
        assert torch.equal(got, ref)
    full = want[0] if passes is None else agg.agg_bwd_rows_plain(
        *inputs[:-1], None)[0][0]
    scale = full.abs().sum(dim=0)
    assert bool(((dbq - want_dbq).abs() <= 1e-6 * scale + 1e-30).all())
    named = torch.zeros(args[0].shape[0], dtype=torch.bool, device=cuda)
    named[args[1].reshape(-1).long()] = True
    assert not parts[0][~named].any()


# runs about the rank's limit of 128, the sort's tile of 2048 and their
# multiples (0, 1, 2 and 3 merges)
LONG_RUNS = [127, 128, 129, 255, 2047, 2048, 2049, 4096, 4097, 6145, 20000]


def _long_run_ids(rng, n, b, t, runs):
    """ids [b, t] of a table of n rows, row i named runs[i] times (at
    random places), the rest of the entries uniform over the rows past
    them."""
    flat = rng.integers(len(runs), n, b * t)
    places = rng.permutation(b * t)
    at = 0
    for row, k in enumerate(runs):
        flat[places[at:at + k]] = row
        at += k
    return flat.reshape(b, t)


@pytest.mark.parametrize("shape", list(SHAPES) + [
    "hubs", "long_runs", "hubs_at_full_graph_size"])
def test_csr_kernels_are_the_stable_sort(cuda, shape):
    """The CSR kernels (counts, scan, atomic fill, each run ranked by a
    warp or, past 128 entries, sorted by a block) equal the plain stable
    sort's CSR, bit for bit, on the full graph's ids, the frontier's, ids
    with a few rows named hundreds of times, runs about the kernels'
    limits, and the full graph's 100k x 10 ids with hubs of 10^4 and 10^5
    entries."""
    rng = np.random.default_rng(8)
    if shape == "hubs":
        nb = rng.integers(0, 5000, (3000, 10))
        nb[rng.random(nb.shape) < 0.2] = rng.integers(0, 4, 1)[0]
        n = 5000
    elif shape == "long_runs":
        n = 9000
        nb = _long_run_ids(rng, n, 6000, 10, LONG_RUNS)
    elif shape == "hubs_at_full_graph_size":
        n = 100_000
        nb = _long_run_ids(rng, n, n, 10, [100_000, 10_000, 3000, 300])
    if shape in ("hubs", "long_runs", "hubs_at_full_graph_size"):
        nb = torch.as_tensor(nb.astype(np.int32), device=cuda)
    else:
        (h, nb, _, _, _), _ = _args(cuda, shape, "f32")
        n = h.shape[0]
    before = agg.csr_launches
    got = agg.backward_csr(nb, n)
    torch.cuda.synchronize()
    assert agg.csr_launches == before + 1
    for a, b in zip(got, agg.backward_csr_plain(nb, n)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["stream", "dma"])
@pytest.mark.parametrize("form", list(FORMS))
def test_two_runs_give_the_same_bits(cuda, form, mode):
    """The whole backward (CSR, kernel, products) twice on the same
    inputs: dh, dWq and dbq equal bit for bit (no float atomics)."""
    args, passes = _args(cuda, "fullgraph", form, seed=1)
    cot = torch.randn((args[1].shape[0], args[3].shape[0]), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(3))

    def grads():
        h, nb, w, Wq, bq = args
        h, Wq, bq = (x.detach().clone().requires_grad_() for x in (h, Wq, bq))
        out = agg.ConvAggregate.apply(h, nb, w, Wq, bq, mode, None, passes,
                                      True)
        return torch.autograd.grad(out, (h, Wq, bq), cot)

    key = mode + (f"_{form}" if form != "f32" else "")
    before = agg.backward_launches[key]
    first, second = grads(), grads()
    torch.cuda.synchronize()
    assert agg.backward_launches[key] == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", list(FORMS))
def test_k3_slope_flag_keeps_the_outputs(cuda, form):
    """K3 with its slope residual on and off: the same outputs, bit for
    bit (the flag adds stores only)."""
    for shape in SHAPES:
        (h, nb, w, Wq, bq), passes = _args(cuda, shape, form, seed=4)
        off = agg.conv_aggregate_cuda(h, nb, w, Wq, bq, "dma", None, passes)
        on, bits = agg.conv_aggregate_cuda(h, nb, w, Wq, bq, "dma", None,
                                           passes, residual=True)
        torch.cuda.synchronize()
        assert torch.equal(on, off)
        assert bits.shape == (nb.numel(), agg.slope_words(Wq.shape[0]))


@pytest.mark.parametrize("mode", ["stream", "dma"])
@pytest.mark.parametrize("form", list(FORMS))
def test_stored_slopes_are_the_plain_forwards(cuda, form, mode):
    """The residual's slopes equal q >= 0 of the plain forward in float64
    (the same rounded operands for the bf16x forms) at every entry but
    those within BRANCH_ATOL of 0."""
    for shape in SHAPES:
        args, passes = _args(cuda, shape, form, seed=5)
        h, nb, w, Wq, bq = args
        kept = agg.conv_aggregate_slopes(*args, mode=mode, passes=passes)
        pre = agg.matmul(h.double(), Wq.double().t(), passes)
        pre = (pre + bq.double())[nb.reshape(-1).long()]
        differ = kept != (pre >= 0)
        worst = float(pre[differ].abs().max()) if differ.any() else 0.0
        assert worst <= BRANCH_ATOL, (int(differ.sum()), worst)


@pytest.mark.parametrize("mode", ["stream", "dma"])
@pytest.mark.parametrize("form", list(FORMS))
def test_gradient_against_float64_autograd(cuda, form, mode):
    """dh, dWq and dbq of ``ConvAggregate`` against float64 autograd
    through the plain version (at the residual's slopes where they differ
    from float64's): the relative Frobenius error of every f32 gradient
    within GRAD_RTOL (the bf16x forms within 1.25x the plain f32
    version's own error where that is larger: their rounded function is
    discontinuous); dh and dWq of a 16-bit table, returned in its type,
    within one ulp of it."""
    args, passes = _args(cuda, "fullgraph", form, seed=6)
    h, nb, w, Wq, bq = args
    b, t = nb.shape
    kept = agg.conv_aggregate_slopes(*args, mode=mode, passes=passes)
    slope = torch.where(kept, 1.0, 0.01).double()
    cot = torch.randn((b, Wq.shape[0]), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(7))

    def at_slopes(h_, Wq_, bq_):
        pre = (agg.matmul(h_, Wq_.t(), passes) + bq_)[nb.reshape(-1).long()]
        q = (pre * slope).reshape(b, t, -1)
        return (w.double()[:, :, None] * q).sum(dim=1) / agg._denominator(
            w.double())

    leaves = [x.detach().double().requires_grad_() for x in (h, Wq, bq)]
    ref = torch.autograd.grad(at_slopes(*leaves), leaves, cot.double())
    leaves = [x.detach().clone().requires_grad_() for x in (h, Wq, bq)]
    got = torch.autograd.grad(agg.ConvAggregate.apply(
        leaves[0], nb, w, leaves[1], leaves[2], mode, None, passes, True),
        leaves, cot)
    leaves = [x.detach().float().requires_grad_() for x in (h, Wq, bq)]
    plain = torch.autograd.grad(agg.conv_aggregate_plain(
        leaves[0], nb, w, leaves[1], leaves[2], passes), leaves, cot)

    def rel(g, r):
        return float(torch.linalg.vector_norm(g.double() - r)
                     / torch.linalg.vector_norm(r))

    for g, p, r in zip(got, plain, ref):
        if g.dtype in agg.SIXTEEN:
            ulp = 2.0 ** (-8 if g.dtype == torch.bfloat16 else -11)
            assert torch.allclose(g.double(), r, rtol=2 * ulp,
                                  atol=1e-3 * float(r.abs().max()))
        else:
            bar = GRAD_RTOL if passes is None else max(GRAD_RTOL,
                                                       1.25 * rel(p, r))
            assert rel(g, r) <= bar, (rel(g, r), rel(p, r))
