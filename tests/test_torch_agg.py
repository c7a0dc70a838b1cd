"""Port's aggregation (K2's plain version) vs the JAX package's XLA path
and its Pallas kernel in interpret mode, at the JAX suite's tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.ops.pallas_agg import (
    conv_aggregate as j_conv_aggregate,
    fused_gather_aggregate,
)
from gcn_song_embeddings_tpu_torch.ops import agg

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
