"""Sub-meshes of the port's multi-device layer and ``scaling_bench``, on
the CPU over gloo (``torch_dist.run_world``).

The JAX script times meshes over ``devices[:nd]`` in one process; the
port's counterpart is ``make_mesh(ranks=...)``, a mesh over some ranks of
the world with a process group of its own (``Mesh.group``) for the
gradient all-reduce, the parameter broadcast, the checkpoint barrier and
the embed's all-gather.  In a world of 4:

* ``ShardedTrainer`` on a graph-sharded mesh over ranks [0, 1] and a dp
  mesh given as ranks [3, 2], trained at once,
  gives the same losses, parameters and embeddings as the whole world of
  2 on those shapes (a mesh numbers its ranks in ascending order, as a
  process group does): bit-equal (the same ops in the same order on the
  CPU), on given batches and on the trainer's own draws (seeded by the
  mesh rank), frontier and full-graph;
* ranks outside a mesh get None; a mesh over every rank, given or by
  default, keeps the world as its group (``Mesh.group`` None), as
  before.

A ``scaling_bench.run`` in a world of 2 returns sizes 1 and 2 with the
JAX script's keys and its efficiency formula.
"""

import ast

import numpy as np
import pytest

from gcn_song_embeddings_tpu_torch import scaling_bench
from torch_capstone import script_tree
from torch_dist import run_world

N, FEAT, B = 64, 16, 8
BASE = {"model.in_dim": FEAT, "model.hidden_dim": 16, "model.out_dim": 8,
        "train.batch_size": B, "train.lr": 1e-3, "train.margin": 0.1,
        "train.batches_per_epoch": 3}
BENCH = {"tracks": 400, "feature_dim": 16, "batch_per_device": 8,
         "steps": 2, "graph_axis": 2, "device": "cpu", "backend": None}


def _payload():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(N, FEAT)).astype(np.float32)
    nb_n = rng.integers(0, N, (N, 10)).astype(np.int32)
    nb_w = np.sort(rng.random((N, 10)).astype(np.float32), 1)[:, ::-1].copy()
    pos = rng.integers(0, N, (200, 2)).astype(np.int32)
    batches = [np.concatenate([pos[rng.integers(0, 200, B)],
                               rng.integers(0, N, (B, 1))], 1)
               .astype(np.int32) for _ in range(3)]
    runs = {"frontier_given": (BASE, batches),
            "frontier_own": (BASE, None),
            "fullgraph_given": ({**BASE, "train.fullgraph_forward": "on"},
                                batches)}
    return {"toy": (feats, nb_w, nb_n, pos), "runs": runs}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    p = _payload()
    four = run_world(tmp_path_factory.mktemp("world4"), 4, "scaling_checks",
                     {**p, "meshes": {
                         "graph01": ([0, 1], 1, 2, True),
                         "dp32": ([3, 2], 2, 1, True),
                         "whole": (None, 2, 2, False),
                         "listed": ([0, 1, 2, 3], 2, 2, False)}})
    two = run_world(tmp_path_factory.mktemp("world2"), 2, "scaling_checks",
                    {**p, "bench": BENCH, "meshes": {
                        "graph": (None, 1, 2, True),
                        "dp": (None, 2, 1, True)}})
    return four, two


def _same(a, b):
    losses, leaves, emb, saved = a
    r_losses, r_leaves, r_emb, r_saved = b
    np.testing.assert_array_equal(losses, r_losses)
    assert leaves.keys() == r_leaves.keys()
    for k in leaves:
        np.testing.assert_array_equal(leaves[k], r_leaves[k])
    np.testing.assert_array_equal(emb, r_emb)
    assert saved and r_saved


@pytest.mark.parametrize("sub,ref", [("graph01", "graph"), ("dp32", "dp")])
@pytest.mark.parametrize("run", ["frontier_given", "frontier_own",
                                 "fullgraph_given"])
def test_a_sub_mesh_trains_as_a_world_of_its_size(worlds, sub, ref, run):
    four, two = worlds
    members = [r for r in range(4) if four[r][("mesh", sub)] is not None]
    assert members == ([0, 1] if sub == "graph01" else [2, 3])
    for r in members:
        mesh_rank, shape, world_group = four[r][("mesh", sub)]
        assert not world_group
        assert mesh_rank == r % 2
        assert two[mesh_rank][("mesh", ref)][1] == shape
        _same(four[r][(sub, run)], two[mesh_rank][(ref, run)])


def test_a_mesh_over_every_rank_keeps_the_world_group(worlds):
    four, two = worlds
    for r in range(4):
        for name in ("whole", "listed"):
            assert four[r][("mesh", name)] == (r, {"dp": 2, "graph": 2},
                                               True)
    for r in range(2):
        assert two[r][("mesh", "graph")][2] and two[r][("mesh", "dp")][2]


def test_scaling_bench_in_a_world_of_2(worlds):
    _, two = worlds
    out = two[0]["bench"]
    assert set(out) == {1, 2, "platform", "backend"}
    assert (out["platform"], out["backend"]) == ("cpu", "gloo")
    assert out[1]["mesh"] == {"dp": 1, "graph": 1}
    assert out[2]["mesh"] == {"dp": 1, "graph": 2}
    for nd in (1, 2):
        assert set(out[nd]) == {"mesh", "step_ms", "edges_per_s",
                                "scaling_efficiency"}
        assert np.isfinite(out[nd]["edges_per_s"])
        assert out[nd]["edges_per_s"] > 0 and out[nd]["step_ms"] > 0
    assert out[1]["scaling_efficiency"] == 1.0
    assert out[2]["scaling_efficiency"] == round(
        out[2]["edges_per_s"] / 2 / out[1]["edges_per_s"], 3)
    # rank 1 sat out size 1 and took part in size 2 only
    assert set(k for k in two[1]["bench"] if isinstance(k, int)) == {2}


def test_the_jax_scripts_sizes_edges_and_data():
    main = next(n for n in script_tree("scaling_bench").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    src = ast.unparse(main)
    assert "edges = sum((m * (T + 1) ** lv * T for lv in range(L)))" in src
    assert "args.batch_per_device * nd" in src
    assert scaling_bench.mesh_sizes(1) == [1]
    assert scaling_bench.mesh_sizes(6) == [1, 2, 4]
    assert scaling_bench.mesh_sizes(8) == [1, 2, 4, 8]
    T, L, bsz = 3, 2, 128
    m = 3 * bsz
    assert scaling_bench.edges_per_step(bsz, L, T) == sum(
        m * (T + 1) ** lv * T for lv in range(L))
    src_data = ("rng.normal(size=(n, args.feature_dim))",
                "rng.integers(0, n, size=(n, 100))",
                "np.sort(rng.random((n, 100)).astype(np.float32), 1)",
                "rng.integers(0, n, size=(50000, 2))")
    at = [src.index(part) for part in src_data]
    assert at == sorted(at)      # the draws the port makes, in its order
    rng = np.random.default_rng(0)
    want = (rng.normal(size=(30, 8)).astype(np.float32),
            rng.integers(0, 30, size=(30, 100)).astype(np.int32),
            np.sort(rng.random((30, 100)).astype(np.float32), 1)[:, ::-1],
            rng.integers(0, 30, size=(50000, 2)).astype(np.int32))
    got = scaling_bench.bench_data(np.random.default_rng(0), 30, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    args = scaling_bench.parse_args([])
    assert (args.tracks, args.feature_dim, args.batch_per_device,
            args.steps, args.graph_axis) == (20000, 256, 64, 30, 2)
