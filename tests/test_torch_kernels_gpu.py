"""CUDA kernels K1 and K2 against their plain PyTorch versions, on the GPU.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX, so they
run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.ops import agg, walk_kernel
from gcn_song_embeddings_tpu_torch.ops.walks import (
    draw_uniforms,
    fused_walk_tables,
    walks_from_fused_tables,
)

pytestmark = pytest.mark.gpu

AGG_ATOL = 1e-4  # f32, another summation order than the einsum path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _graph(device, n_items=300, n_cols=60, deg=4, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_cols, (n_items, deg))
    i2c_indptr = np.arange(n_items + 1, dtype=np.int32) * deg
    src = np.repeat(np.arange(n_items, dtype=np.int32), deg)
    flat = cols.reshape(-1)
    order = np.lexsort((src, flat))
    c2i_indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=n_cols), out=c2i_indptr[1:])
    return DeviceGraph.from_arrays(i2c_indptr, flat, c2i_indptr, src[order],
                                   device)


@pytest.mark.parametrize("alpha,b,hops,chains", [
    (0.85, 7, 40, 1), (0.0, 7, 25, 1), (0.85, 4096, 500, 1),
    (0.85, 33, 60, 2)])
def test_walk_kernel_bit_identical(cuda, alpha, b, hops, chains):
    tables = fused_walk_tables(_graph(cuda))
    nodeset = torch.randint(0, 300, (b,), dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b)
    uniforms = draw_uniforms(hops // chains, b * chains, gen)
    before = walk_kernel.launches
    got = walk_kernel.restart_walks(tables, nodeset, hops, alpha, uniforms,
                                    chains)
    want = walks_from_fused_tables(tables, nodeset, hops, alpha, uniforms,
                                   chains)
    torch.cuda.synchronize()
    assert walk_kernel.launches == before + 1
    assert got.shape == (b, hops) and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,t,n,din,h", [
    (300, 3, 1000, 256, 128), (65, 3, 1000, 256, 128),
    (1000, 10, 5000, 512, 512), (777, 10, 5000, 128, 512),
    (50, 7, 200, 36, 100)])
def test_agg_kernel_matches_plain(cuda, b, t, n, din, h):
    rng = np.random.default_rng(b)
    args = [torch.as_tensor(a, device=cuda) for a in (
        rng.normal(size=(n, din)).astype(np.float32),
        rng.integers(0, n, (b, t)).astype(np.int32),
        rng.random((b, t)).astype(np.float32),
        (rng.normal(size=(h, din)) * 0.05).astype(np.float32),
        np.full(h, 0.3, np.float32))]
    args[2][3] = 0.0                      # all-zero neighborhood guard
    before = agg.launches
    got = agg.conv_aggregate(*args)
    want = agg.conv_aggregate_plain(*args)
    torch.cuda.synchronize()
    assert agg.launches == before + 1
    assert got.shape == (b, h)
    assert float((got - want).abs().max()) <= AGG_ATOL


def test_kernels_reject_what_they_do_not_take(cuda):
    h = torch.zeros((10, 8), device=cuda)
    ids = torch.zeros((4, 65), dtype=torch.int32, device=cuda)
    w = torch.ones((4, 65), device=cuda)
    with pytest.raises(ValueError, match="T <="):
        agg.conv_aggregate(h, ids, w, torch.zeros((6, 8), device=cuda),
                           torch.zeros(6, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        agg.conv_aggregate(h.double(), ids[:, :3], w[:, :3],
                           torch.zeros((6, 8), device=cuda).double(),
                           torch.zeros(6, device=cuda).double())
    for din, hdim in ((37, 8), (8, 6)):   # float4 loads: multiples of 4
        with pytest.raises(ValueError, match="multiples of 4"):
            agg.conv_aggregate(torch.zeros((10, din), device=cuda),
                               ids[:, :3], w[:, :3],
                               torch.zeros((hdim, din), device=cuda),
                               torch.zeros(hdim, device=cuda))
    tables = fused_walk_tables(_graph(cuda))
    with pytest.raises(ValueError, match="uniforms"):
        walk_kernel.restart_walks(tables, ids[0, :4], 5, 0.5,
                                  torch.zeros((5, 3, 3), device=cuda))
