"""The port's multi-device layer (``parallel/``, ``ops.ppr``'s
multi-device sweep, CLI ``train --mesh-graph``) against the JAX package,
on the CPU.

The port runs as a gloo world of 4 processes (``torch_dist.run_world``,
spawned once for the module); JAX runs on its virtual 8-device CPU mesh
(``tests/conftest.py``) with the same mesh shape, ``make_mesh(...,
devices=jax.devices()[:4])``.  Randomness is an input: the walkers get
the uniforms JAX's walkers draw (``fold_in(key, dev)``), the partitioned
sweep JAX's per-block draws, and the trainers the batches JAX's
``device_step`` draws (``fold_in(PRNGKey(seed + 1), chunk)``, ``split``,
``fold_in(kdev, dev)``, ``split(., 3)``) with JAX's initial params.
Tolerances: bit-equal for gathers, traces and top-T ids; rtol 1e-4 /
atol 1e-5 for 3-step trajectories (``test_torch_train.py``'s TRAJ);
atol 2e-4 for embeddings (``test_parallel.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.config import (
    RunConfig as JRunConfig,
    WalkConfig as JWalkConfig,
    config_with_overrides as j_overrides,
)
from gcn_song_embeddings_tpu.models.pinsage import init_pinsage as j_init
from gcn_song_embeddings_tpu.ops.ppr import (
    precompute_neighborhoods as j_precompute,
)
from gcn_song_embeddings_tpu.parallel.mesh import make_mesh as j_make_mesh
from gcn_song_embeddings_tpu.parallel.train_step import (
    ShardedTrainer as JShardedTrainer,
)
from gcn_song_embeddings_tpu.parallel.walks_sharded import (
    make_sharded_walker as j_walker,
    make_sharded_walker_fused as j_walker_fused,
    precompute_neighborhoods_partitioned as j_partitioned,
    shard_graph as j_shard_graph,
    shard_graph_fused as j_shard_graph_fused,
)
from gcn_song_embeddings_tpu.train.sampler import (
    sample_easy_negatives as j_easy,
    sample_positive_rows as j_positive_rows,
)
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    WalkConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    _load_cache,
    precompute_neighborhoods,
)
from gcn_song_embeddings_tpu_torch.ops.walks import (
    fused_walk_tables,
    walks_from_fused_tables,
)
from gcn_song_embeddings_tpu_torch.parallel import multihost
from gcn_song_embeddings_tpu_torch.parallel.mesh import Mesh
from gcn_song_embeddings_tpu_torch.parallel.train_step import ShardedTrainer
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from torch_dist import run_world
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
TRAJ = dict(rtol=1e-4, atol=1e-5)
N_HOPS, ALPHA, W_RANK = 16, 0.85, 16
WALK_CFG = dict(n_hops=24, t_precompute=5, batch_walkers=128)
TOY = {"model.in_dim": 32, "model.hidden_dim": 32, "model.out_dim": 16,
       "train.batch_size": 64, "train.lr": 1e-3, "train.margin": 0.1}
TRAINERS = [("frontier", {**TOY, "train.fullgraph_forward": "off"},
             "psum_scatter"),
            ("fullgraph", {**TOY, "train.fullgraph_forward": "on"},
             "psum_scatter"),
            ("ring", {**TOY, "train.fullgraph_forward": "off"}, "ring"),
            ("hard", {**TOY, "train.hard_negatives": True,
                      "train.hn_min": 1, "train.hn_max": 6}, "psum_scatter")]


def _toy(n=256, d=32, t_store=8, seed=0):
    """tests/test_parallel.py's toy problem."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, d)).astype(np.float32)
    nb_n = rng.integers(0, n, size=(n, t_store)).astype(np.int32)
    nb_n = np.where(nb_n == np.arange(n)[:, None], (nb_n + 1) % n, nb_n)
    nb_w = np.sort(rng.random((n, t_store)).astype(np.float32),
                   axis=1)[:, ::-1].copy()
    pos = rng.integers(0, n, size=(1024, 2)).astype(np.int32)
    return feat, nb_w, nb_n, pos


def _jmesh():
    return j_make_mesh(n_dp=2, n_graph=2, devices=jax.devices()[:WORLD])


def _tree(params) -> dict:
    """A JAX PinSageParams as plain dicts of numpy arrays."""
    params = jax.device_get(params)
    return {"layers": [{f: np.asarray(getattr(layer, f))
                        for f in ("Wq", "bq", "Ww", "bw")}
                       for layer in params.layers],
            **{f: np.asarray(getattr(params, f))
               for f in ("G1_w", "G1_b", "G2_w")}}


def _flat(tree) -> dict:
    out = {f"layers[{i}].{f}": layer[f]
           for i, layer in enumerate(tree["layers"]) for f in layer}
    return {**out, **{f: tree[f] for f in ("G1_w", "G1_b", "G2_w")}}


def _jax_batches(jcfg, positives, nb_n, n_items, n_batches):
    """The batches JAX's ShardedTrainer draws in its first chunk, per
    device (parallel/train_step.py device_step's key schedule)."""
    tc = jcfg.train
    b = tc.batch_size // WORLD
    keys = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(tc.seed + 1), 0), n_batches)
    pos_j = jnp.asarray(positives)
    out = []
    for key in keys:
        per = []
        for dev in range(WORLD):
            _, kdev = jax.random.split(key)
            kp, kn, kr = jax.random.split(jax.random.fold_in(kdev, dev), 3)
            pb = np.asarray(j_positive_rows(kp, pos_j, b, exact=False))
            if tc.hard_negatives:
                ranks = np.asarray(jax.random.randint(
                    kr, (b,), tc.hn_min, tc.hn_max))
                neg = nb_n[pb[:, 0], ranks]
            else:
                neg = np.asarray(j_easy(kn, jnp.asarray(pb), n_items))
            per.append(np.concatenate([pb, neg[:, None]], axis=1)
                       .astype(np.int32))
        out.append(per)
    return out


def _csr(graph):
    return (graph.i2c.indptr, graph.i2c.indices, graph.c2i.indptr,
            graph.c2i.indices)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, graph, device_graph):
    """JAX's side of every check, then one gloo world of 4 running the
    port's side (``torch_dist.parallel_checks``)."""
    rng = np.random.default_rng(0)
    jmesh = _jmesh()
    p = {"table": rng.normal(size=(61, 5)).astype(np.float32),
         "itable": rng.integers(-9, 9, size=(61, 6)).astype(np.int32),
         "ids": rng.integers(0, 61, size=(WORLD, 23)).astype(np.int32),
         "grads": rng.normal(size=(WORLD, 23, 5)).astype(np.float32),
         "csr": _csr(graph), "n_hops": N_HOPS, "alpha": ALPHA,
         "walk_nodes": rng.integers(0, graph.n_items, WORLD * W_RANK)
         .astype(np.int32), "walk_cfg": WALK_CFG}
    ref = {"walk": {}}
    p["walk_u"] = {}
    key = jax.random.PRNGKey(5)
    for fused in (False, True):
        sg = (j_shard_graph_fused if fused else j_shard_graph)(
            device_graph, jmesh)
        for chains in (1, 2):
            walker = (j_walker_fused if fused else j_walker)(
                jmesh, sg, N_HOPS, ALPHA, n_chains=chains)
            ref["walk"][(fused, chains)] = np.asarray(
                walker(jnp.asarray(p["walk_nodes"]), key))
            p["walk_u"][(fused, chains)] = np.stack([np.asarray(
                jax.random.uniform(jax.random.fold_in(key, dev),
                                   (N_HOPS // chains, W_RANK * chains, 3)))
                for dev in range(WORLD)])

    jwcfg = JWalkConfig(**WALK_CFG)
    ref["partitioned"] = j_partitioned(device_graph, jwcfg, jmesh, seed=0)
    sweep = WALK_CFG["batch_walkers"]
    p["part_u"] = {}
    for start in range(0, graph.n_items, sweep):
        k = jax.random.fold_in(jax.random.PRNGKey(0), start)
        for dev in range(WORLD):
            p["part_u"][(start, dev)] = np.asarray(jax.random.uniform(
                jax.random.fold_in(k, dev),
                (WALK_CFG["n_hops"], sweep // WORLD, 3)))

    feat, nb_w, nb_n, pos = p["toy"] = _toy(seed=11)
    jcfg0 = j_overrides(JRunConfig(), TOY)
    p["jparams"] = _tree(j_init(
        jax.random.PRNGKey(jcfg0.train.seed), jcfg0.model.n_layers,
        feat.shape[1], jcfg0.model.hidden_dim, jcfg0.model.out_dim,
        jcfg0.model.bias_init))
    p["trainers"], p["batches"], ref["train"] = TRAINERS, {}, {}
    for name, over, impl in TRAINERS:
        jcfg = j_overrides(JRunConfig(), over)
        p["batches"][name] = _jax_batches(jcfg, pos, nb_n, feat.shape[0], 3)
        if name == "ring":
            # JAX's ring schedule trains as its default does
            # (tests/test_parallel.py); the port's ring run is held to it
            ref["train"][name] = ref["train"]["frontier"]
            continue
        jtr = JShardedTrainer(jmesh, jcfg, feat.shape[0], feat, (nb_w, nb_n),
                              pos, gather_impl=impl)
        losses = np.asarray(jtr.train_chunk(3))
        ref["train"][name] = (losses, _flat(_tree(jtr.params)),
                              jtr.embed(batch_size=64)
                              if name in ("frontier", "fullgraph") else None)
    results = run_world(tmp_path_factory.mktemp("world4"), WORLD,
                        "parallel_checks", p)
    return p, ref, results


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_gathers_are_bit_equal_to_indexing(world4, shape):
    p, _, results = world4
    for rank, out in enumerate(results):
        res = out[("gather", shape)]
        for name, table in (("f32", p["table"]), ("i32", p["itable"])):
            want = table[p["ids"][rank]]
            np.testing.assert_array_equal(res[(name, "scatter")], want)
            np.testing.assert_array_equal(res[(name, "ring")], want)
            assert res[(name, "ring")].dtype == table.dtype


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_gather_backward_is_the_single_process_gradient(world4, shape):
    """The table gradient of sum(gather(ids_r) * G_r), each graph group's
    shards put end to end, against one process's autograd of indexing."""
    p, _, results = world4
    n_dp, g = shape
    for d in range(n_dp):
        ranks = range(d * g, (d + 1) * g)
        table = torch.from_numpy(p["table"]).requires_grad_(True)
        loss = sum((table[torch.from_numpy(p["ids"][r]).long()]
                    * torch.from_numpy(p["grads"][r])).sum() for r in ranks)
        loss.backward()
        for form in ("scatter", "ring"):
            got = np.concatenate([results[r][("gather", shape)][
                ("f32", form, "grad")] for r in ranks])[:len(p["table"])]
            np.testing.assert_allclose(got, table.grad.numpy(), rtol=1e-6,
                                       atol=1e-6)


WALKS = [(False, 1), (False, 2), (True, 1), (True, 2)]


@pytest.mark.parametrize("fused,chains", WALKS)
def test_sharded_walkers_replay_jax(world4, fused, chains):
    _, ref, results = world4
    got = np.concatenate([out[("walk", fused, chains)] for out in results])
    assert got.shape == (WORLD * W_RANK, N_HOPS) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref["walk"][(fused, chains)])


@pytest.mark.parametrize("fused,chains", WALKS)
def test_sharded_walkers_equal_the_single_process_walk(world4, graph,
                                                       fused, chains):
    p, _, results = world4
    tables = fused_walk_tables(DeviceGraph.from_arrays(*_csr(graph), "cpu"))
    for rank, out in enumerate(results):
        nodes = torch.from_numpy(
            p["walk_nodes"][rank * W_RANK:(rank + 1) * W_RANK])
        want = walks_from_fused_tables(
            tables, nodes, N_HOPS, ALPHA,
            torch.from_numpy(p["walk_u"][(fused, chains)][rank]), chains)
        np.testing.assert_array_equal(out[("walk", fused, chains)],
                                      want.numpy())


def test_multichip_sweep_equals_the_single_process_sweep(world4, graph):
    _, _, results = world4
    dg = DeviceGraph.from_arrays(*_csr(graph), "cpu")
    w1, n1 = precompute_neighborhoods(dg, WalkConfig(**WALK_CFG), None,
                                      seed=0)
    for out in results:
        w, n = out["multichip"]
        np.testing.assert_array_equal(w, w1)
        np.testing.assert_array_equal(n, n1)


def test_multichip_cache_is_read_by_both_packages(world4, graph,
                                                  device_graph):
    """Rank 0 wrote the sweep's cache; its meta is the single-process
    sweep's, so both packages load it as it is."""
    _, _, results = world4
    path = os.path.join(os.path.dirname(results[0]["resume"]["path"]),
                        "multichip.npz")
    w, n = results[0]["multichip"]
    dg = DeviceGraph.from_arrays(*_csr(graph), "cpu")
    got = _load_cache(path, graph.n_items, WALK_CFG["t_precompute"],
                      WalkConfig(**WALK_CFG), 0, dg.n_edges)
    jw, jn = j_precompute(device_graph, JWalkConfig(**WALK_CFG), path,
                          seed=0)
    for a, b in ((got[0], w), (got[1], n), (jw, w), (jn, n)):
        np.testing.assert_array_equal(a, b)


def test_partitioned_sweep_replays_jax(world4):
    """Fed the uniforms JAX's partitioned sweep draws, the port's
    partitioned sweep (fused walker, world of 4) gives JAX's artifact."""
    _, ref, results = world4
    jw, jn = ref["partitioned"]
    for out in results:
        w, n = out["partitioned"]
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(w, jw)


def test_partitioned_sweep_distribution(world4, graph):
    """tests/test_parallel.py's check of JAX's partitioned sweep, on the
    port's own draws with the four-gather walker: finite non-negative
    weights, every top-1 neighbor 2-hop reachable, the same artifact on
    every rank."""
    _, _, results = world4
    w, n = results[0]["partitioned_own"]
    assert w.shape == (graph.n_items, WALK_CFG["t_precompute"])
    assert (w >= 0).all() and np.isfinite(w).all()
    i2c_ptr, i2c_idx, c2i_ptr, c2i_idx = _csr(graph)
    for q in range(graph.n_items):
        if w[q, 0] == 0:
            continue
        two_hop = set()
        for c in i2c_idx[i2c_ptr[q]:i2c_ptr[q + 1]]:
            two_hop.update(c2i_idx[c2i_ptr[c]:c2i_ptr[c + 1]].tolist())
        assert int(n[q, 0]) in two_hop
    for out in results[1:]:
        np.testing.assert_array_equal(out["partitioned_own"][1], n)


@pytest.mark.parametrize("name", [t[0] for t in TRAINERS])
def test_sharded_trajectory_matches_jax(world4, name):
    """3 steps from JAX's init on JAX's batches: the losses and every
    parameter at TRAJ, the same on every rank."""
    _, ref, results = world4
    want_losses, want_leaves, _ = ref["train"][name]
    losses, leaves, _, fullgraph = results[0][("train", name)]
    assert fullgraph == (name == "fullgraph")
    np.testing.assert_allclose(losses, want_losses, **TRAJ)
    for leaf, want in want_leaves.items():
        np.testing.assert_allclose(leaves[leaf], want, **TRAJ,
                                   err_msg=leaf)
    for out in results[1:]:
        np.testing.assert_array_equal(out[("train", name)][0], losses)
        for leaf in leaves:
            np.testing.assert_array_equal(out[("train", name)][1][leaf],
                                          leaves[leaf])


@pytest.mark.parametrize("name", ["frontier", "fullgraph"])
def test_sharded_embed_matches_jax(world4, name):
    _, ref, results = world4
    for out in results:
        emb = out[("train", name)][2]
        assert emb.shape == ref["train"][name][2].shape
        np.testing.assert_allclose(emb, ref["train"][name][2], atol=2e-4)


def test_ring_gather_trains_like_the_default(world4):
    _, _, results = world4
    a, b = results[0][("train", "frontier")], results[0][("train", "ring")]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2], b[2])


def test_hard_negatives_come_from_the_sharded_table(world4):
    p, _, results = world4
    _, _, nb_n, _ = p["toy"]
    for out in results:
        batch = out["hard_batch"]
        assert batch.shape == (16, 3) and batch.dtype == np.int32
        for q, _, neg in batch:
            assert neg in nb_n[q, 2:7]


def test_hn_start_epoch_gate_reads_the_adam_count(world4):
    """Easy negatives before epoch hn_start_epoch (Adam count 0), hard
    ones from the sharded table once the count reaches it."""
    p, _, results = world4
    _, _, nb_n, _ = p["toy"]
    hits = [[n in nb_n[q, 2:7] for q, _, n in out["gated_batches"][i]]
            for out in results for i in (0, 1)]
    assert all(all(h) for h in hits[1::2])
    assert not all(all(h) for h in hits[0::2])


def test_exact_sampling_gives_each_rank_a_disjoint_block(world4):
    p, _, results = world4
    pos = p["toy"][3]
    rows = np.concatenate([out["exact_batch"][:, :2] for out in results])
    index = {tuple(r): i for i, r in enumerate(pos.tolist())}
    hit = [index.get(tuple(r)) for r in rows.tolist()]
    assert None not in hit and len(rows) == 64
    # distinct positive pairs up to duplicates in the positives themselves
    assert len({tuple(r) for r in rows.tolist()}) >= 60


def test_resume_mid_epoch_replays_the_continuous_run(world4):
    """2 batches, checkpoint (mid-epoch: 3 a epoch), a new trainer
    resumes and takes 2 more: bit-equal to 4 batches in one trainer."""
    _, _, results = world4
    for out in results:
        r = out["resume"]
        assert r["loaded"] and r["progress"] == (2, 0)
        assert r["resumed_losses"] == r["full_losses"][2:]
        for leaf in r["full"]:
            np.testing.assert_array_equal(r["resumed"][leaf],
                                          r["full"][leaf])


def test_sharded_checkpoint_loads_in_pinsage_trainer(world4, tmp_path):
    """The sharded state.npz (rank 0's) resumes a single-device
    PinSageTrainer: progress, params and Adam state."""
    p, _, results = world4
    r = results[0]["resume"]
    feat, nb_w, nb_n, pos = p["toy"]
    run = tmp_path / "runs" / "sh"
    run.mkdir(parents=True)
    os.replace(r["path"], run / "state.npz")
    cfg = config_with_overrides(RunConfig(run_name="sh"), {
        **TOY, "train.batches_per_epoch": 3})
    n = feat.shape[0]
    dg = DeviceGraph.from_arrays(np.arange(n + 1), np.zeros(n), [0, n],
                                 np.arange(n), "cpu")
    tr = PinSageTrainer(dg, n, feat, pos, cfg=cfg,
                        base_run_dir=str(tmp_path / "runs"),
                        nbhds=(nb_w, nb_n), log=False, verbose=False)
    assert (tr.e, tr.b, tr.opt.count) == (0, 2, 2)
    for name, leaf in tr.params.leaves():
        np.testing.assert_array_equal(leaf.detach().numpy(), r["half"][name])


def _fake_mesh():
    return Mesh(1, 1, 0, torch.device("cpu"), None)


def test_sharded_trainer_refuses_bad_configs():
    feat, nb_w, nb_n, pos = _toy()
    for over, match in (({"train.hard_negatives": True, "train.hn_max": 9},
                         "hn_max"),
                        ({"train.dtype": "bfloat16"}, "float32"),
                        ({"train.fullgraph_forward": "maybe"}, "auto"),
                        ({"train.batch_size": 63}, "divide")):
        cfg = config_with_overrides(RunConfig(), {**TOY, **over})
        mesh = _fake_mesh() if "batch_size" not in str(over) else Mesh(
            1, 2, 0, torch.device("cpu"), None)
        with pytest.raises(ValueError, match=match):
            ShardedTrainer(mesh, cfg, feat.shape[0], feat, (nb_w, nb_n), pos)
    with pytest.raises(ValueError, match="gather_impl"):
        ShardedTrainer(_fake_mesh(), config_with_overrides(RunConfig(), TOY),
                       feat.shape[0], feat, (nb_w, nb_n), pos,
                       gather_impl="nope")


def test_multihost_world_of_one_and_refusals(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize_multihost(num_processes=2, device="cpu")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="incomplete"):
        multihost.initialize_multihost(device="cpu")
    monkeypatch.delenv("RANK")
    try:
        assert multihost.initialize_multihost(device="cpu") == 0
        assert multihost.initialize_multihost(device="cpu") == 0  # again
        assert multihost.rank_device() == torch.device("cpu")
        mesh = multihost.make_global_mesh(n_graph=1)
        assert (mesh.shape, mesh.rank, mesh.graph_index) == (
            {"dp": 1, "graph": 1}, 0, 0)
    finally:
        multihost.shutdown()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        multihost.rank_device()


def test_cli_train_mesh_graph_as_a_world_of_one(tmp_path, monkeypatch):
    """``train --mesh-graph 1`` alone: a world of one trains sharded,
    writes emb.npy, config.json and state.npz, and a second run resumes
    the finished state and writes the same embeddings."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    ds = str(tmp_path / "ds")
    cli.main(["synth", "--dataset", ds, "--n-tracks", "150",
              "--n-collections", "40", "--n-positives", "500",
              "--feature-dim", "16", "--seed", "2"])
    runs = str(tmp_path / "runs")
    argv = ["train", "--dataset", ds, "--run-dir", runs, "--run-name", "m",
            "--device", "cpu", "--mesh-graph", "1",
            "--set", "train.epochs=1", "--set", "train.batches_per_epoch=3",
            "--set", "train.batch_size=8", "--set", "walk.n_hops=50",
            "--set", "model.hidden_dim=32", "--set", "model.out_dim=16"]
    cli.main(argv)
    run = os.path.join(runs, "m")
    emb = np.load(os.path.join(run, "emb.npy"))
    assert emb.shape == (150, 16) and np.isfinite(emb).all()
    with open(os.path.join(run, "config.json")) as f:
        assert RunConfig.from_json(f.read()).model.in_dim == 16
    assert not torch.distributed.is_initialized()
    cli.main(argv)
    np.testing.assert_array_equal(np.load(os.path.join(run, "emb.npy")), emb)
    # the sharded run's checkpoint embeds through `cli embed` as well
    out = str(tmp_path / "e.npy")
    cli.main(["embed", "--dataset", ds, "--out", out, "--checkpoint",
              os.path.join(run, "state.npz"), "--device", "cpu"])
    np.testing.assert_allclose(np.load(out), emb, atol=1e-5)
