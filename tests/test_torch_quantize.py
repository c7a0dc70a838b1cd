"""The port's int8 quantization and int8 scoring vs the jitted JAX
functions, and the plain version of kernel K4 against the stochastic
quantizer's contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.ops.quantize import int8_scores as j_scores
from gcn_song_embeddings_tpu.ops.quantize import int8_topk as j_topk
from gcn_song_embeddings_tpu.ops.quantize import quantize_rows as j_quantize
from gcn_song_embeddings_tpu_torch.ops import quant_kernel
from gcn_song_embeddings_tpu_torch.ops.quantize import (
    int8_scores,
    int8_topk,
    pad_table,
    quantize_rows,
)


def _unit(n, d, seed=0):
    e = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _zero_row(e):
    e = e.copy()
    e[min(1, len(e) - 1)] = 0.0
    return e


@pytest.mark.parametrize("table", [
    _unit(20_000, 128), _unit(1, 128, seed=1), _zero_row(_unit(50, 128, 2)),
    _unit(700, 64, seed=3)], ids=["20000x128", "n1", "zero_row", "d64"])
def test_quantize_rows_bit_identical_to_jax(table):
    """Values and scales array_equal to the jitted JAX function (its
    absmax / 127 is a multiply by f32(1/127) under XLA)."""
    jv, js = j_quantize(jnp.asarray(table))
    v, s = quantize_rows(torch.from_numpy(table))
    assert v.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("b", [1, 37])
def test_int8_scores_bit_identical_to_jitted_jax(b):
    """The serving path always runs int8_scores jitted (the eager JAX
    function rounds the query scale otherwise)."""
    table = _unit(1001, 128, seed=4)
    jv, js = j_quantize(jnp.asarray(table))
    query = _unit(b, 128, seed=5)
    want = np.asarray(jax.jit(j_scores)(jv, js, jnp.asarray(query)))
    v, s = quantize_rows(torch.from_numpy(table))
    got = int8_scores(v, s, torch.from_numpy(query))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same table padded once, as the serving index holds it
    pv, ps = pad_table(v, s)
    assert pv.shape == (1008, 128) and not ps[1001:].any()
    padded = int8_scores(pv, ps, torch.from_numpy(query))
    np.testing.assert_array_equal(padded[:, :1001].numpy(), want)
    assert not padded[:, 1001:].any()


def test_int8_scores_zero_query_and_width_limit():
    v, s = quantize_rows(torch.from_numpy(_unit(40, 16)))
    zero = int8_scores(v, s, torch.zeros((2, 16)))
    assert not zero.any()
    with pytest.raises(ValueError, match="d <= 1040"):
        int8_scores(torch.zeros((8, 1048), dtype=torch.int8),
                    torch.ones(8), torch.ones((1, 1048)))


def test_int8_topk_matches_jax():
    """Scores equal; ids equal up to ties (equal int32 sums times equal
    row scales)."""
    table = _unit(800, 64, seed=1)
    jv, js = j_quantize(jnp.asarray(table))
    jw, jn = j_topk(jv, js, jnp.asarray(table[:32]), 10)
    v, s = quantize_rows(torch.from_numpy(table))
    w, n = int8_topk(v, s, torch.from_numpy(table[:32]), 10)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    jw, jn = np.asarray(jw), np.asarray(jn)
    for i in range(32):
        for score in np.unique(jw[i])[1:]:       # the lowest may be cut
            assert (set(n[i][w[i] == score].tolist())
                    == set(jn[i][jw[i] == score].tolist()))
    assert (n[:, 0].numpy() == np.arange(32)).all()


# -------------------------------------------- K4's plain version
# The JAX kernel (quantize_rows_pallas) cannot run on the CPU: its
# pltpu.prng_seed has no interpret lowering, and tests/test_quantize.py
# skips there.  Its bits are the TPU's own, so no test could compare values
# anyway; the contract of tests/test_quantize.py:36-48 stands in for it.


def test_stochastic_quantizer_meets_the_pallas_contract():
    emb = _unit(500, 64)[:300]                   # tests/test_quantize.py's
    t = torch.from_numpy(emb)
    v_det, s_det = quantize_rows(t)
    before = quant_kernel.launches
    v_sto, s_sto = quant_kernel.quantize_rows_stochastic(t, seed=3)
    assert v_sto.dtype == torch.int8 and v_sto.shape == (300, 64)
    np.testing.assert_allclose(s_det.numpy(), s_sto.numpy(), rtol=1e-6)
    assert int((v_det.int() - v_sto.int()).abs().max()) <= 1
    deq = v_sto.float() * s_sto[:, None]
    assert abs(float((deq - t).mean())) < 1e-4
    assert bool((v_sto != v_det).any())          # it does round at random
    assert quant_kernel.launches == before       # CPU tensors: no kernel


def test_stochastic_quantizer_is_unbiased_per_element():
    """Over many seeds each value's mean dequantization tends to x."""
    t = torch.from_numpy(_unit(8, 16, seed=7))
    deq = torch.stack([
        (lambda vs: vs[0].float() * vs[1][:, None])(
            quant_kernel.quantize_rows_stochastic(t, seed=s))
        for s in range(400)])
    step = float(quantize_rows(t)[1].max())
    assert float((deq.mean(0) - t).abs().max()) < 0.1 * step


def test_stochastic_quantizer_seeds():
    t = torch.from_numpy(_zero_row(_unit(64, 32, seed=2)))
    a = quant_kernel.quantize_rows_stochastic(t, seed=11)
    b = quant_kernel.quantize_rows_stochastic(t, seed=11)
    c = quant_kernel.quantize_rows_stochastic(t, seed=12)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    assert float(a[1][1]) == 1.0 and not a[0][1].any()   # the zero row


def test_random_bits_are_the_kernels_hash():
    """The plain version's int64 arithmetic, masked to 32 bits, against
    the same hash on Python integers."""
    def fmix32(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    key = fmix32(5 ^ 0x9E3779B9)
    assert quant_kernel.seed_key(5) == key
    bits = quant_kernel.random_bits(5, 9, 12)
    want = [[fmix32(fmix32(r ^ key) ^ c) for c in range(12)]
            for r in range(9)]
    assert bits.tolist() == want
    u = (quant_kernel.random_bits(0, 512, 128) >> 8).float() * 2.0 ** -24
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_stochastic_quantizer_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 4"):
        quant_kernel.quantize_rows_stochastic(torch.zeros((4, 130)))
    with pytest.raises(ValueError, match="float32"):
        quant_kernel.quantize_rows_stochastic(
            torch.zeros((4, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        quant_kernel.quantize_rows_cuda(torch.zeros((4, 8)))
