"""The port's f16 mixed-precision training (``train.dtype="float16"``) and
its ``"float64"`` (trained as f32) against the JAX package's, on the CPU
at a small size.

The JAX trainer casts with ``jnp.dtype(tcfg.dtype)``: "float16" trains in
f16 exactly as "bfloat16" trains in bf16 (f32 masters and Adam, a 16-bit
feature table, 16-bit casts of the masters, f32 accumulation), and
"float64" trains in f32 with a truncation warning (x64 is never
enabled).  Inputs are made from a seed with numpy and handed to both
packages; the params are JAX's ``init_pinsage`` carried across with
``params_from_numpy``.  The bars are tests/test_torch_bf16.py's, restated
in f16 units:

* the f16 aggregation, plain version against JAX: atol 2e-5, the f32
  aggregation's own bar -- an f16 x f16 product is exact in f32, so only
  the order of the f32 sums differs;
* one f16 step: the loss within 1e-3 relative; each gradient entry
  within one f16 ulp (rtol 2^-10, atol 1e-6), because both packages
  round every parameter's gradient to f16 on its way back through the
  cast and an f32 sum taken in another order can land on the other side
  of an f16 rounding boundary; entries beyond that are counted and held
  under 0.1 %;
* three steps: losses within 1e-3 relative, every master leaf within one
  f16 ulp of its value plus 2 lr (Adam moves an entry by at most ~lr a
  step).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from gcn_song_embeddings_tpu.config import (
    PinSageConfig as JPinSageConfig,
    RunConfig as JRunConfig,
    TrainConfig as JTrainConfig,
)
from gcn_song_embeddings_tpu.models import pinsage as jp
from gcn_song_embeddings_tpu.ops.pallas_agg import (
    conv_aggregate as j_conv_aggregate,
    fused_gather_aggregate as j_fused,
)
from gcn_song_embeddings_tpu.train import loss as jloss
from gcn_song_embeddings_tpu.train.trainer import (
    make_optimizer as j_make_optimizer,
)
from gcn_song_embeddings_tpu.utils.checkpoint import load_pytree
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.config import (
    PinSageConfig,
    RunConfig,
    TrainConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.models import pinsage as tp
from gcn_song_embeddings_tpu_torch.ops import agg
from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh
from gcn_song_embeddings_tpu_torch.parallel.train_step import ShardedTrainer
from gcn_song_embeddings_tpu_torch.train import trainer as ttrainer
from gcn_song_embeddings_tpu_torch.utils.checkpoint import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

N, IN, HID, OUT, L, T, B = 300, 24, 16, 8, 2, 4, 8
AGG_ATOL = 2e-5
LOSS_RTOL = 1e-3
ULP = 2.0 ** -10  # one f16 ulp, relative
GRAD = dict(rtol=ULP, atol=1e-6)
MAX_BEYOND = 1e-3  # share of gradient entries allowed past one f16 ulp
F16 = jnp.float16


def _f16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to f16 (as f32): the inputs both packages see."""
    return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)


def _agg_problem(b, t, n, din, hdim, seed, zero_row=None):
    rng = np.random.default_rng(seed)
    h = _f16(rng.normal(size=(n, din)))
    ids = rng.integers(0, n, (b, t)).astype(np.int32)
    w = rng.random((b, t)).astype(np.float32)
    if zero_row is not None:
        w[zero_row] = 0.0
    Wq = _f16(rng.normal(size=(hdim, din)) * 0.2)
    bq = _f16(np.full(hdim, 0.3))
    return h, ids, w, Wq, bq


def _port_agg_inputs(h, ids, w, Wq, bq, w_dtype=torch.float32):
    return (torch.from_numpy(h).half(), torch.from_numpy(ids),
            torch.from_numpy(w).to(w_dtype), torch.from_numpy(Wq).half(),
            torch.from_numpy(bq))


@pytest.mark.parametrize("b,t,din,hdim,zero_row", [
    (65, 3, 24, 16, 3), (40, 10, 32, 20, None), (7, 5, 24, 16, 0)])
def test_f16_aggregation_plain_matches_jax(b, t, din, hdim, zero_row):
    """f16 table and Wq, f32 weights (the frontier forward's): the port's
    plain aggregation and ``conv_aggregate`` on CPU tensors against the
    JAX package's XLA path on the same f16 arrays (its einsum with
    ``preferred_element_type=f32``), and against its Pallas kernel in
    interpret mode."""
    h, ids, w, Wq, bq = _agg_problem(b, t, 200, din, hdim, 1, zero_row)
    jh, jwq, jbq = (jnp.asarray(x).astype(F16) for x in (h, Wq, bq))
    want = np.asarray(j_conv_aggregate(jh, jnp.asarray(ids), jnp.asarray(w),
                                       jwq, jbq))
    pallas = np.asarray(j_fused(jh, jnp.asarray(ids), jnp.asarray(w), jwq,
                                jbq, interpret=True))
    args = _port_agg_inputs(h, ids, w, Wq, bq)
    got = agg.conv_aggregate_plain(*args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=AGG_ATOL)
    np.testing.assert_allclose(got.numpy(), pallas, atol=AGG_ATOL)
    for mode in agg.MODES:
        np.testing.assert_allclose(
            agg.conv_aggregate(*args, mode=mode).numpy(), want,
            atol=AGG_ATOL)


def test_f16_fullgraph_aggregation_takes_the_f16_denominator():
    """f16 weights (the full-graph forward's): JAX sums them in f32 and
    rounds the sum to f16; ``_denominator`` does the same, bit for bit,
    and the plain aggregation, ``project_table_plain`` +
    ``gather_mean_plain`` and ``tp.aggregate`` hold JAX's output."""
    h, ids, w, Wq, bq = _agg_problem(90, 10, 150, 24, 16, 2, zero_row=5)
    w = _f16(w)
    jw = jnp.asarray(w).astype(F16)
    j_sum = jw.sum(axis=1, keepdims=True)
    assert j_sum.dtype == F16
    want_den = np.asarray(jnp.where(j_sum == 0.0, 1.0, j_sum)
                          .astype(jnp.float32))
    args = _port_agg_inputs(h, ids, w, Wq, bq, w_dtype=torch.float16)
    np.testing.assert_array_equal(agg._denominator(args[2]).numpy(),
                                  want_den)
    # the f32 sum of these weights differs from its f16 rounding
    assert (np.abs(w.sum(axis=1, keepdims=True) - want_den) > 0).any()
    want = np.asarray(j_conv_aggregate(
        jnp.asarray(h).astype(F16), jnp.asarray(ids), jw,
        jnp.asarray(Wq).astype(F16), jnp.asarray(bq).astype(F16)))
    proj = agg.project_table_plain(args[0], args[3], args[4])
    for got in (agg.conv_aggregate_plain(*args),
                agg.gather_mean_plain(proj, args[1], args[2]),
                tp.aggregate(args[0], args[1], args[2], args[3],
                             torch.from_numpy(bq).half())):
        np.testing.assert_allclose(got.numpy(), want, atol=AGG_ATOL)


@pytest.mark.parametrize("call, match", [
    (lambda: agg.tile_wq16(torch.zeros(16, 8)), "Wq must be a bf16 or f16"),
    (lambda: agg.tile_wq16(torch.zeros(16, 8, dtype=torch.float16)),
     "launches on CUDA"),
    (lambda: agg.project_table16(torch.zeros(4, 8),
                                 torch.zeros(1, 1, 128, 64),
                                 torch.zeros(16)), "h must be a bf16 or f16"),
    (lambda: agg.l2_read_probe(torch.zeros(64), 2), "launches on CUDA"),
    (lambda: agg.l2_read_probe(torch.zeros(6), 2), "multiple of 4"),
], ids=["tile-f32", "tile-cpu", "project-f32", "probe-cpu", "probe-size"])
def test_16bit_cuda_entry_points_refuse_on_the_cpu(call, match):
    """The 16-bit wrappers take either 16-bit type and dispatch on it, and
    launch only on CUDA tensors: there is no CPU path behind them."""
    with pytest.raises(ValueError, match=match):
        call()


def test_f16_aggregate_pads_to_the_16bit_load_width():
    """An f16 table of Din 20 is padded to 24 (8 values a 16-byte load)
    and H 18 to 20; the output is the unpadded aggregation."""
    h, ids, w, Wq, bq = _agg_problem(30, 5, 60, 20, 18, 3)
    args = _port_agg_inputs(h, ids, w, Wq, bq)
    got = tp.aggregate(*args, mode="dma")
    assert got.shape == (30, 18)
    torch.testing.assert_close(got, agg.conv_aggregate_plain(*args),
                               rtol=0, atol=AGG_ATOL)


# ------------------------------------------------------------ one f16 step

def _problem(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, IN)).astype(np.float32)
    w = np.sort(rng.random((N, T + 2)).astype(np.float32), axis=1)[:, ::-1]
    w = np.ascontiguousarray(w)
    w[::7, T - 1:] = 0.0                   # zero-weight tails
    w[5] = 0.0                             # an all-zero neighborhood
    nodes = rng.integers(0, N, (N, T + 2)).astype(np.int32)
    return feats, w, nodes


def _batches(k, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, N, (B, 3)).astype(np.int32) for _ in range(k)]


def _cfgs(dtype="float16"):
    kw = dict(lr=1e-3, margin=0.1, batch_size=B, batches_per_epoch=2,
              decay=0.5, dtype=dtype)
    return (TrainConfig(**kw), PinSageConfig(in_dim=IN, hidden_dim=HID,
                                             out_dim=OUT, n_layers=L, T=T),
            JRunConfig(train=JTrainConfig(**kw),
                       model=JPinSageConfig(in_dim=IN, hidden_dim=HID,
                                            out_dim=OUT, n_layers=L, T=T)))


def _jax_f16_loss_fn(feats, w, nodes, batch, margin, fullgraph):
    """The loss of the JAX trainer's ``_train_chunk`` under
    train.dtype="float16" (trainer.py:99-160): params cast inside the
    loss, the feature table f16, the full graph's weights f16."""
    f = jnp.asarray(feats).astype(F16)
    b = jnp.asarray(batch)
    nd = jnp.concatenate([b[:, 0], b[:, 1], b[:, 2]])

    def loss_fn(params):
        pc = jax.tree.map(lambda x: x.astype(F16), params)
        if fullgraph:
            h_all = jp.fullgraph_embeddings(
                pc, f, jnp.asarray(w).astype(F16), jnp.asarray(nodes), L, T)
            emb = jp.head_apply(pc, h_all[nd]).astype(jnp.float32)
        else:
            packed = jp.pack_nbhds(jnp.asarray(w), jnp.asarray(nodes), T)
            emb = jp.forward_with_gather(
                pc, lambda ids: f[ids], jp.packed_nbhd_gather(packed, T),
                nd, L, T).astype(jnp.float32)
        h_q, h_pos, h_neg = jnp.split(emb, 3, axis=0)
        return jloss.max_margin_loss(h_q, h_pos, h_neg, margin)
    return loss_fn


def _jax_leaves(tree):
    return ([np.asarray(getattr(layer, f)) for layer in tree.layers
             for f in ("Wq", "bq", "Ww", "bw")]
            + [np.asarray(getattr(tree, f)) for f in ("G1_w", "G1_b",
                                                      "G2_w")])


def _port_params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _hold_grads(names, grads, want, what):
    """Each gradient within one f16 ulp of JAX's; the entries beyond are
    printed and their share held under MAX_BEYOND."""
    beyond = total = 0
    for name, g, w in zip(names, grads, want):
        bad = ~np.isclose(g, w, **GRAD)
        beyond += int(bad.sum())
        total += bad.size
        if bad.any():
            print(f"{what} {name}: {int(bad.sum())} of {bad.size} entries "
                  f"beyond one f16 ulp, max |diff| "
                  f"{float(np.abs(g - w).max()):.3g}")
    assert beyond <= MAX_BEYOND * total, (beyond, total)


@pytest.mark.parametrize("fullgraph", [False, True])
def test_one_f16_step_matches_jax(fullgraph):
    """One fixed batch, the same params: the port's f16 loss and every f32
    master gradient (frontier forward: the f16 K3 form on layer 0; full
    graph: f16 tables in both layers) against jax.value_and_grad of the
    JAX trainer's f16 loss."""
    feats, w, nodes = _problem()
    batch = _batches(1)[0]
    jparams = jp.init_pinsage(jax.random.PRNGKey(0), L, IN, HID, OUT)
    tcfg, mcfg, _ = _cfgs()
    want_loss, want_grads = jax.value_and_grad(_jax_f16_loss_fn(
        feats, w, nodes, batch, tcfg.margin, fullgraph))(jparams)
    params = _port_params(jparams)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T,
                                        dtype="float16")
    assert tables.step_features.dtype == torch.float16
    assert tables.features.dtype == torch.float32
    loss, _ = ttrainer.triple_loss(params, tables, torch.from_numpy(batch),
                                   tcfg, mcfg, fullgraph)
    leaves = [p for _, p in params.leaves()]
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 for g in grads)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    _hold_grads([name for name, _ in params.leaves()],
                [g.numpy() for g in grads], _jax_leaves(want_grads),
                "fullgraph" if fullgraph else "frontier")


@pytest.mark.parametrize("fullgraph", [False, True])
def test_f16_gradients_are_rounded_to_f16_as_in_jax(fullgraph):
    """JAX rounds each parameter's gradient to f16 on its way back through
    the cast (the cotangent of an f16 leaf is f16), and so does the
    port's ``p.to(torch.float16)``: every gradient entry of both is an
    f16 value."""
    feats, w, nodes = _problem(2)
    batch = _batches(1, seed=3)[0]
    jparams = jp.init_pinsage(jax.random.PRNGKey(1), L, IN, HID, OUT)
    tcfg, mcfg, _ = _cfgs()
    _, jgrads = jax.value_and_grad(_jax_f16_loss_fn(
        feats, w, nodes, batch, tcfg.margin, fullgraph))(jparams)
    params = _port_params(jparams)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T,
                                        dtype="float16")
    loss, _ = ttrainer.triple_loss(params, tables, torch.from_numpy(batch),
                                   tcfg, mcfg, fullgraph)
    grads = torch.autograd.grad(loss, [p for _, p in params.leaves()])
    for g in _jax_leaves(jgrads) + [g.numpy() for g in grads]:
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, _f16(g))


def test_f16_three_step_trajectory_matches_jax():
    """train_step x 3 in f16 (master weights and Adam in f32) against
    value_and_grad of the JAX f16 loss + the JAX optimizer on the same
    batches: losses within 1e-3 relative, every master leaf within one
    f16 ulp of its value plus 2 lr."""
    feats, w, nodes = _problem(4)
    batches = _batches(3, seed=5)
    jparams = jp.init_pinsage(jax.random.PRNGKey(2), L, IN, HID, OUT)
    tcfg, mcfg, jcfg = _cfgs()
    tx = j_make_optimizer(jcfg)
    opt_state = tx.init(jparams)
    params = _port_params(jparams)
    want_losses = []
    for batch in batches:
        loss, grads = jax.value_and_grad(_jax_f16_loss_fn(
            feats, w, nodes, batch, tcfg.margin, False))(jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_losses.append(float(loss))
    opt = ttrainer.make_optimizer(params, tcfg)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T,
                                        dtype="float16")
    metrics = [ttrainer.train_step(params, opt, torch.from_numpy(b), tables,
                                   tcfg, mcfg, fullgraph=False).numpy()
               for b in batches]
    np.testing.assert_allclose([m[0] for m in metrics], want_losses,
                               rtol=LOSS_RTOL)
    for (name, got), want in zip(params.leaves(), _jax_leaves(jparams)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=ULP,
                                   atol=2 * tcfg.lr, err_msg=name)


def test_dtype_names_as_jnp_dtype_reads_them():
    """The port reads train.dtype as the JAX trainer's ``jnp.dtype`` does:
    the float types and their numpy aliases train, "float64" ("double")
    as f32; a name ``jnp.dtype`` refuses, and a type that is no float the
    step trains in, are refused."""
    for name, want in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16),
                       ("float16", torch.float16), ("half", torch.float16),
                       ("float64", torch.float32),
                       ("double", torch.float32)):
        jnp.dtype(name)                    # JAX takes it
        assert ttrainer.step_dtype(name) == want, name
    for name in ("bf16", "fp16", "float17"):
        with pytest.raises(TypeError):
            jnp.dtype(name)
        with pytest.raises(ValueError, match="names no type"):
            ttrainer.step_dtype(name)
    with pytest.raises(ValueError, match="trains in"):
        ttrainer.step_dtype("int8")


# -------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def port_graph(dataset_dir):
    return SongGraph(dataset_dir,
                     features_file=os.path.join(dataset_dir, "features.npy"))


@pytest.fixture(scope="module")
def port_positives(port_graph, dataset_dir):
    return port_graph.load_positives(
        os.path.join(dataset_dir, "positives.json"))


def _trainer(graph, positives, base, run_name="t", **over):
    """tests/test_trainer.py's ``_mk_trainer`` on the port."""
    overrides = {"train.epochs": 2, "train.batches_per_epoch": 10,
                 "train.batch_size": 32, "walk.n_hops": 100,
                 "walk.batch_walkers": 256}
    overrides.update(over)
    cfg = config_with_overrides(RunConfig(run_name=run_name), overrides)
    return ttrainer.PinSageTrainer(
        DeviceGraph.from_graph(graph, "cpu"), graph.n_items, graph.features,
        positives, cfg=cfg, base_run_dir=str(base),
        nbhds_path=os.path.join(str(base), "nbhds.npz"), log=True,
        load_save=True, verbose=False)


def test_f16_checkpoint_holds_f32_masters_and_resumes(
        port_graph, port_positives, tmp_path):
    """An f16 run's state.npz holds the f32 master leaves under the JAX key
    paths (the JAX package's ``load_pytree`` reads them into its params),
    ``embed`` reads the f32 table and masters (an f32 trainer on the same
    state embeds the same bits), and a resumed run replays a continuous
    one."""
    kw = {"train.dtype": "float16", "train.checkpoint_every_batches": 5}
    full = _trainer(port_graph, port_positives, tmp_path / "a", "r", **kw)
    full.train()
    half = _trainer(port_graph, port_positives, tmp_path / "b", "r",
                    **{**kw, "train.epochs": 1})
    half.train()
    resumed = _trainer(port_graph, port_positives, tmp_path / "b", "r", **kw)
    assert (resumed.e, resumed.b) == (1, 0)
    resumed.train()
    for (name, a), (_, b) in zip(full.params.leaves(),
                                 resumed.params.leaves()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=name)
    template = {"params": jp.init_pinsage(
        jax.random.PRNGKey(0), L, port_graph.features.shape[1], 512, 128)}
    tree, scalars = load_pytree(full.state_path, template)
    assert scalars["epochs_done"] == 2
    got = _jax_leaves(tree["params"])
    for (name, leaf), arr in zip(full.params.leaves(), got):
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, leaf.detach().numpy(),
                                      err_msg=name)
    f32 = _trainer(port_graph, port_positives, tmp_path / "a", "r",
                   **{"train.checkpoint_every_batches": 5})
    assert f32.opt.count == full.opt.count
    np.testing.assert_array_equal(f32.embed(), full.embed())


def test_float64_warns_once_and_trains_as_float32(port_graph,
                                                  port_positives, tmp_path):
    """``"float64"`` as the JAX trainer takes it without x64: one warning,
    then the f32 run bit for bit (losses, every master leaf, the
    embeddings)."""
    kw = {"train.epochs": 1, "train.batches_per_epoch": 4}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        f64 = _trainer(port_graph, port_positives, tmp_path / "a", "r",
                       **{**kw, "train.dtype": "float64"})
        f64.train()
    said = [str(w.message) for w in caught if "float64" in str(w.message)]
    assert len(said) == 1 and "float32" in said[0], said
    f32 = _trainer(port_graph, port_positives, tmp_path / "b", "r", **kw)
    f32.train()
    assert f64.tables.step_features.dtype == torch.float32
    with open(os.path.join(f64.run_dir, "metrics.jsonl")) as a, \
            open(os.path.join(f32.run_dir, "metrics.jsonl")) as b:
        assert a.read() == b.read()
    for (name, x), (_, y) in zip(f64.params.leaves(), f32.params.leaves()):
        np.testing.assert_array_equal(x.detach().numpy(),
                                      y.detach().numpy(), err_msg=name)
    np.testing.assert_array_equal(f64.embed(), f32.embed())


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_sharded_step_trains_other_dtypes_in_f32(dtype, tmp_path):
    """The sharded step, as the JAX package's (which never reads
    train.dtype), warns once and trains in f32 on any dtype but float32:
    f16 and float64 take the path bf16 takes
    (tests/test_torch_parallel.py ``test_sharded_bf16_config_trains_in_
    f32``).  A world of one on gloo: two steps bit-equal to float32's."""
    rng = np.random.default_rng(0)
    n = 64
    feat = rng.normal(size=(n, 16)).astype(np.float32)
    nb_w = rng.random((n, 6)).astype(np.float32)
    nb_n = rng.integers(0, n, (n, 6)).astype(np.int32)
    pos = rng.integers(0, n, (100, 2)).astype(np.int32)

    def run(dt):
        cfg = config_with_overrides(RunConfig(), {
            "train.batch_size": 8, "model.hidden_dim": 16,
            "model.out_dim": 8, "model.T": 3, "train.dtype": dt})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr = ShardedTrainer(make_mesh(device="cpu"), cfg, n, feat,
                                (nb_w, nb_n), pos)
        said = [str(w.message) for w in caught
                if "does not apply" in str(w.message)]
        return tr.train_chunk(2), tr, said

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        losses, tr, said = run(dtype)
        want, ref, quiet = run("float32")
    finally:
        dist.destroy_process_group()
    assert len(said) == 1 and dtype in said[0] and not quiet, said
    np.testing.assert_array_equal(losses, want)
    for (name, x), (_, y) in zip(tr.params.leaves(), ref.params.leaves()):
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(x.detach().numpy(),
                                      y.detach().numpy(), err_msg=name)


def test_cli_train_in_f16(tmp_path):
    """``train --set train.dtype="float16"`` as the JAX CLI takes it: the
    run's config.json says float16, its state holds f32 leaves, emb.npy is
    finite."""
    ds = str(tmp_path / "ds")
    cli.main(["synth", "--dataset", ds, "--n-tracks", "150",
              "--n-collections", "40", "--n-positives", "500",
              "--feature-dim", "16", "--seed", "2"])
    runs = str(tmp_path / "runs")
    cli.main(["train", "--dataset", ds, "--run-dir", runs, "--run-name",
              "h", "--device", "cpu", "--set", "train.epochs=1",
              "--set", "train.batches_per_epoch=3",
              "--set", "train.batch_size=8", "--set", "walk.n_hops=50",
              "--set", "model.hidden_dim=32", "--set", "model.out_dim=16",
              "--set", 'train.dtype="float16"'])
    run = os.path.join(runs, "h")
    with open(os.path.join(run, "config.json")) as f:
        assert RunConfig.from_json(f.read()).train.dtype == "float16"
    with np.load(os.path.join(run, "state.npz")) as z:
        assert all(z[k].dtype == np.float32 for k in z.files
                   if k.startswith("['params']"))
    emb = np.load(os.path.join(run, "emb.npy"))
    assert emb.shape == (150, 16) and np.isfinite(emb).all()
