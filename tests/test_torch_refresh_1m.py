"""The port's ``refresh_1m`` against ``scripts/refresh_1m_check.py``, and
the nodeset sweep it shares with ``refresh_neighborhoods``, on the CPU.

``ops.ppr._neighborhood_sweep_nodeset``, fed the uniforms JAX draws for
each block, equals JAX's ``_neighborhood_sweep_nodeset`` bit for bit (a
generator in place of the uniforms draws one block after another).  On a
tiny port ``scale_demo`` capstone work dir, ``refresh_1m.main`` finds the
trainer's standing artifact, prints the JAX script's keys (``platform``
naming the device), writes into the work dir and keeps every unaffected
row bit for bit; its ``tv_rows`` equals the JAX script's on lists with
zero weights, ties and disjoint supports.
"""

import ast
import json
import os

import jax
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.data import SongGraph as JSongGraph
from gcn_song_embeddings_tpu.data.device import DeviceGraph as JDeviceGraph
from gcn_song_embeddings_tpu.ops.ppr import (
    _neighborhood_sweep_nodeset as j_sweep_nodeset,
)
from gcn_song_embeddings_tpu_torch import refresh_1m
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    _neighborhood_sweep_nodeset,
    seeded_generator,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    draw_uniforms,
    fused_walk_tables,
)
from torch_capstone import (
    REPO,
    assigned_dict,
    capstone_work_dir,
    dict_keys,
    script_tree,
)
from torch_threads import one_torch_thread  # noqa: F401

HOPS, ALPHA, T, BATCH, BLOCKS = 40, 0.85, 12, 32, 3


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    from gcn_song_embeddings_tpu.data import make_synthetic_dataset

    ds = make_synthetic_dataset(
        str(tmp_path_factory.mktemp("nodeset") / "ds"), n_tracks=500,
        n_collections=120, n_clusters=5, tracks_per_collection=10,
        n_positives=800, seed=21)
    return (JDeviceGraph.from_graph(JSongGraph(ds)),
            DeviceGraph.from_graph(SongGraph(ds), "cpu"))


def _jax_block_uniforms(key):
    """JAX's draws for block i of a nodeset sweep under ``key``:
    uniform(fold_in(key, i), [hops, batch, 3])."""
    def uniforms(start, n_walkers):
        assert start % BATCH == 0 and n_walkers == BATCH
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, start // BATCH), (HOPS, n_walkers, 3))))
    return uniforms


def test_nodeset_sweep_fed_jax_uniforms_equals_jax(graphs):
    jdg, dg = graphs
    origins = np.random.default_rng(3).integers(
        0, 500, BATCH * BLOCKS).astype(np.int32)
    key = jax.random.PRNGKey(7)
    want_w, want_n = j_sweep_nodeset(jdg, jax.numpy.asarray(origins), HOPS,
                                     ALPHA, T, key, BATCH, BLOCKS)
    done = []
    got_w, got_n = _neighborhood_sweep_nodeset(
        fused_walk_tables(dg), torch.as_tensor(origins), HOPS, ALPHA, T,
        _jax_block_uniforms(key), BATCH, progress=done.append)
    assert got_w.dtype == torch.float32 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert done == [BATCH, 2 * BATCH, 3 * BATCH]


def test_nodeset_sweep_pads_the_last_block_and_takes_a_generator(graphs):
    """A generator is drawn from block by block, as a callable drawing
    from it in turn; a ragged last block is padded with its last origin,
    so each row equals its own block's walk."""
    _, dg = graphs
    tables = fused_walk_tables(dg)
    origins = torch.arange(0, 500, 7, dtype=torch.int32)[:70]
    got = _neighborhood_sweep_nodeset(tables, origins, HOPS, ALPHA, T,
                                      seeded_generator([5], "cpu"), BATCH)
    gen = seeded_generator([5], "cpu")
    want = _neighborhood_sweep_nodeset(
        tables, origins, HOPS, ALPHA, T,
        lambda start, n: draw_uniforms(HOPS, n, gen), BATCH)
    for g, w in zip(got, want):
        assert g.shape == (70, T)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _jax_tv_rows():
    """The ``tv_rows`` nested in scripts/refresh_1m_check.py's main."""
    tree = script_tree("refresh_1m_check")
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "tv_rows")
    scope = {"np": np}
    exec(compile(ast.fix_missing_locations(ast.Module(
        body=[node], type_ignores=[])), "refresh_1m_check", "exec"), scope)
    return scope["tv_rows"]


def test_tv_rows_equals_the_jax_scripts():
    rng = np.random.default_rng(11)
    wa = rng.random((40, 12)).astype(np.float32)
    wb = rng.random((40, 12)).astype(np.float32)
    wa[:, 8:] = 0.0                                  # zero-weight tails
    wb[5] = wa[5]
    na = rng.integers(0, 30, (40, 12)).astype(np.int32)
    nb = rng.integers(0, 30, (40, 12)).astype(np.int32)
    nb[5] = na[5]                                    # an identical row
    nb[6] = na[6] + 100                              # disjoint supports
    got = refresh_1m.tv_rows(wa, na, wb, nb)
    np.testing.assert_array_equal(got, _jax_tv_rows()(wa, na, wb, nb))
    assert got[5] == 0.0 and got[6] > 0.0


@pytest.fixture(scope="module")
def capstone(tmp_path_factory):
    return capstone_work_dir(str(tmp_path_factory.mktemp("capstone")))


def test_main_prints_the_jax_keys_and_keeps_unaffected_rows(capstone,
                                                            capsys):
    before = sorted(os.listdir(os.path.join(REPO, "results")))
    args = ["--work-dir", capstone, "--pair-counts", "10,100",
            "--parity-sample", "64", "--device", "cpu"]
    result = refresh_1m.main(args)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
    tree = script_tree("refresh_1m_check")
    assert set(result) == dict_keys(assigned_dict(tree, "result"))
    assert result["platform"] == "cpu" and result["n_tracks"] == 2000
    assert [r["new_pairs"] for r in result["rows"]] == [10, 100]
    for row in result["rows"]:
        assert set(row) == dict_keys(assigned_dict(tree, "row"))
        assert 0 < row["affected"] <= 2000
    assert result["parity_sample"] == 64
    with open(os.path.join(capstone, "refresh_1m.json")) as f:
        assert json.load(f) == result
    assert sorted(os.listdir(os.path.join(REPO, "results"))) == before

    run = refresh_1m.run(refresh_1m.parse_args(args), log=lambda *a: None)
    # the trainer's sweep is the standing artifact: nothing swept again
    assert run.standing_cached
    assert run.unaffected_equal == {10: True, 100: True}
    # the same seeds give the same rows and parity
    assert run.result["rows"][0]["affected"] == result["rows"][0]["affected"]
    assert run.result["tv_seed_noise"] == result["tv_seed_noise"]
