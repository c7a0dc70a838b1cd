"""The port's bf16 mixed-precision training (``train.dtype="bfloat16"``)
against the JAX package's, on the CPU at a small size.

Inputs are made from a seed with numpy and handed to both packages; the
params are JAX's ``init_pinsage`` carried across with
``params_from_numpy``.  Tolerances and why:

* the bf16 aggregation, plain version against JAX: atol 2e-5, the f32
  aggregation's own bar -- a bf16 x bf16 product is exact in f32, so
  only the order of the f32 sums differs;
* one bf16 step: the loss within 1e-3 relative; each gradient entry
  within one bf16 ulp (rtol 2^-7, atol 1e-6), because both packages
  round every parameter's gradient to bf16 on its way back through the
  cast and an f32 sum taken in another order can land on the other side
  of a bf16 rounding boundary; entries beyond that are counted and held
  under 0.1 % (the expected cause is such a flip at an inter-layer bf16
  cast, which moves everything downstream of it by an ulp);
* the JAX suite's own bf16 quality bars (tests/test_trainer.py):
  finite falling losses, f32 master weights, hit@100 above 0.8 of the
  f32 run's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.train import trainer as ttrainer
from gcn_song_embeddings_tpu_torch.utils.checkpoint import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

N, IN, HID, OUT, L, T, B = 300, 24, 16, 8, 2, 4, 8
AGG_ATOL = 2e-5
LOSS_RTOL = 1e-3
GRAD = dict(rtol=2.0 ** -7, atol=1e-6)
MAX_BEYOND = 1e-3  # share of gradient entries allowed past one bf16 ulp
BF = jnp.bfloat16


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (as f32): the inputs both packages see."""
    return np.array(jnp.asarray(x).astype(BF).astype(jnp.float32))


def _agg_problem(b, t, n, din, hdim, seed, zero_row=None):
    rng = np.random.default_rng(seed)
    h = _bf16(rng.normal(size=(n, din)).astype(np.float32))
    ids = rng.integers(0, n, (b, t)).astype(np.int32)
    w = rng.random((b, t)).astype(np.float32)
    if zero_row is not None:
        w[zero_row] = 0.0
    Wq = _bf16(rng.normal(size=(hdim, din)).astype(np.float32) * 0.2)
    bq = _bf16(np.full(hdim, 0.3, np.float32))
    return h, ids, w, Wq, bq


def _port_agg_inputs(h, ids, w, Wq, bq, w_dtype=torch.float32):
    return (torch.from_numpy(h).bfloat16(), torch.from_numpy(ids),
            torch.from_numpy(w).to(w_dtype), torch.from_numpy(Wq).bfloat16(),
            torch.from_numpy(bq))


@pytest.mark.parametrize("b,t,din,hdim,zero_row", [
    (65, 3, 24, 16, 3), (40, 10, 32, 20, None), (7, 5, 24, 16, 0)])
def test_bf16_aggregation_plain_matches_jax(b, t, din, hdim, zero_row):
    """bf16 table and Wq, f32 weights (the frontier forward's): the port's
    plain aggregation and ``conv_aggregate`` on CPU tensors against the
    JAX package's XLA path on the same bf16 arrays, and against its Pallas
    kernel in interpret mode (which upcasts the bf16 operands)."""
    h, ids, w, Wq, bq = _agg_problem(b, t, 200, din, hdim, 1, zero_row)
    jh, jwq, jbq = (jnp.asarray(x).astype(BF) for x in (h, Wq, bq))
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


def test_bf16_fullgraph_aggregation_takes_the_bf16_denominator():
    """bf16 weights (the full-graph forward's): JAX sums them in f32 and
    rounds the sum to bf16; ``_denominator`` does the same, bit for bit,
    and the plain aggregation, ``project_table_plain`` +
    ``gather_mean_plain`` and ``tp.aggregate`` hold JAX's output."""
    h, ids, w, Wq, bq = _agg_problem(90, 10, 150, 24, 16, 2, zero_row=5)
    w = _bf16(w)
    jw = jnp.asarray(w).astype(BF)
    j_sum = jw.sum(axis=1, keepdims=True)
    assert j_sum.dtype == BF
    want_den = np.asarray(jnp.where(j_sum == 0.0, 1.0, j_sum)
                          .astype(jnp.float32))
    args = _port_agg_inputs(h, ids, w, Wq, bq, w_dtype=torch.bfloat16)
    np.testing.assert_array_equal(agg._denominator(args[2]).numpy(),
                                  want_den)
    # the f32 sum of these weights differs from its bf16 rounding
    assert (np.abs(w.sum(axis=1, keepdims=True) - want_den) > 0).any()
    want = np.asarray(j_conv_aggregate(
        jnp.asarray(h).astype(BF), jnp.asarray(ids), jw,
        jnp.asarray(Wq).astype(BF), jnp.asarray(bq).astype(BF)))
    proj = agg.project_table_plain(args[0], args[3], args[4])
    for got in (agg.conv_aggregate_plain(*args),
                agg.gather_mean_plain(proj, args[1], args[2]),
                tp.aggregate(args[0], args[1], args[2], args[3],
                             torch.from_numpy(bq).bfloat16())):
        np.testing.assert_allclose(got.numpy(), want, atol=AGG_ATOL)


def test_bf16_aggregate_pads_to_the_bf16_load_width():
    """A bf16 table of Din 20 is padded to 24 (8 bf16 a 16-byte load) and
    H 18 to 20; the output is the unpadded aggregation."""
    h, ids, w, Wq, bq = _agg_problem(30, 5, 60, 20, 18, 3)
    args = _port_agg_inputs(h, ids, w, Wq, bq)
    got = tp.aggregate(*args, mode="dma")
    assert got.shape == (30, 18)
    torch.testing.assert_close(got, agg.conv_aggregate_plain(*args),
                               rtol=0, atol=AGG_ATOL)


def test_bf16_backward_recomputes_pre_in_f32_and_returns_bf16():
    """``ConvAggregate``'s table-form backward on a bf16 table and Wq:
    dh and dWq come back in bf16, dbq in f32.  dWq and dbq are within one
    bf16 ulp of autograd through the plain version (JAX's arithmetic).
    dh sums each table row's gradient in f32 and rounds once, so it is
    within one bf16 ulp of the float64 gradient; the plain version (as
    JAX's scatter-add) rounds each gathered row's gradient to bf16 and
    accumulates them in bf16, which drifts further."""
    h, ids, w, Wq, bq = _agg_problem(50, 6, 40, 24, 16, 4, zero_row=1)
    cot = torch.from_numpy(np.random.default_rng(5).normal(
        size=(50, 16)).astype(np.float32))

    def leaves(dtype=None):
        hh, nb, ww, wq, b = _port_agg_inputs(h, ids, w, Wq, bq)
        if dtype is not None:
            hh, ww, wq, b = (x.to(dtype) for x in (hh, ww, wq, b))
        return (hh.requires_grad_(), nb, ww, wq.requires_grad_(),
                b.requires_grad_())

    hh, nb, ww, wq, b = leaves()
    got = torch.autograd.grad(
        agg.ConvAggregate.apply(hh, nb, ww, wq, b, "stream", None, None,
                                True), (hh, wq, b),
        cot)
    hh, nb, ww, wq, b = leaves()
    plain = torch.autograd.grad(agg.conv_aggregate_plain(hh, nb, ww, wq, b),
                                (hh, wq, b), cot)
    hh, nb, ww, wq, b = leaves(torch.float64)
    exact = torch.autograd.grad(agg.conv_aggregate_plain(hh, nb, ww, wq, b),
                                (hh, wq, b), cot.double())
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    for g, r in zip(got[1:], plain[1:]):
        np.testing.assert_allclose(g.float().numpy(), r.float().numpy(),
                                   **GRAD)
    np.testing.assert_allclose(got[0].float().numpy(), exact[0].numpy(),
                               **GRAD)


# ---------------------------------------------------------- one bf16 step

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


def _cfgs():
    kw = dict(lr=1e-3, margin=0.1, batch_size=B, batches_per_epoch=2,
              decay=0.5, dtype="bfloat16")
    return (TrainConfig(**kw), PinSageConfig(in_dim=IN, hidden_dim=HID,
                                             out_dim=OUT, n_layers=L, T=T),
            JRunConfig(train=JTrainConfig(**kw),
                       model=JPinSageConfig(in_dim=IN, hidden_dim=HID,
                                            out_dim=OUT, n_layers=L, T=T)))


def _jax_bf16_loss_fn(feats, w, nodes, batch, margin, fullgraph):
    """The loss of the JAX trainer's ``_train_chunk`` under
    train.dtype="bfloat16" (trainer.py:99-160): params cast inside the
    loss, the feature table bf16, the full graph's weights bf16."""
    f = jnp.asarray(feats).astype(BF)
    b = jnp.asarray(batch)
    nd = jnp.concatenate([b[:, 0], b[:, 1], b[:, 2]])

    def loss_fn(params):
        pc = jax.tree.map(lambda x: x.astype(BF), params)
        if fullgraph:
            h_all = jp.fullgraph_embeddings(
                pc, f, jnp.asarray(w).astype(BF), jnp.asarray(nodes), L, T)
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
    """Each gradient within one bf16 ulp of JAX's; the entries beyond are
    printed and their share held under MAX_BEYOND."""
    beyond = total = 0
    for name, g, w in zip(names, grads, want):
        bad = ~np.isclose(g, w, **GRAD)
        beyond += int(bad.sum())
        total += bad.size
        if bad.any():
            print(f"{what} {name}: {int(bad.sum())} of {bad.size} entries "
                  f"beyond one bf16 ulp, max |diff| "
                  f"{float(np.abs(g - w).max()):.3g}")
    assert beyond <= MAX_BEYOND * total, (beyond, total)


@pytest.mark.parametrize("fullgraph", [False, True])
def test_one_bf16_step_matches_jax(fullgraph):
    """One fixed batch, the same params: the port's bf16 loss and every
    f32 master gradient (frontier forward: bf16 K3 form on layer 0; full
    graph: bf16 tables in both layers) against jax.value_and_grad of the
    JAX trainer's bf16 loss."""
    feats, w, nodes = _problem()
    batch = _batches(1)[0]
    jparams = jp.init_pinsage(jax.random.PRNGKey(0), L, IN, HID, OUT)
    tcfg, mcfg, _ = _cfgs()
    want_loss, want_grads = jax.value_and_grad(_jax_bf16_loss_fn(
        feats, w, nodes, batch, tcfg.margin, fullgraph))(jparams)
    params = _port_params(jparams)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T,
                                        dtype="bfloat16")
    assert tables.step_features.dtype == torch.bfloat16
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
def test_bf16_gradients_are_rounded_to_bf16_as_in_jax(fullgraph):
    """JAX rounds each parameter's gradient to bf16 on its way back
    through the cast (the cotangent of a bf16 leaf is bf16; pinned here on
    the CPU), and so does the port's ``p.to(torch.bfloat16)``: every
    gradient entry of both is a bf16 value."""
    feats, w, nodes = _problem(2)
    batch = _batches(1, seed=3)[0]
    jparams = jp.init_pinsage(jax.random.PRNGKey(1), L, IN, HID, OUT)
    tcfg, mcfg, _ = _cfgs()
    _, jgrads = jax.value_and_grad(_jax_bf16_loss_fn(
        feats, w, nodes, batch, tcfg.margin, fullgraph))(jparams)
    params = _port_params(jparams)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T,
                                        dtype="bfloat16")
    loss, _ = ttrainer.triple_loss(params, tables, torch.from_numpy(batch),
                                   tcfg, mcfg, fullgraph)
    grads = torch.autograd.grad(loss, [p for _, p in params.leaves()])
    for g in _jax_leaves(jgrads) + [g.numpy() for g in grads]:
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, _bf16(g))


def test_bf16_three_step_trajectory_matches_jax():
    """train_step x 3 in bf16 (master weights and Adam in f32) against
    value_and_grad of the JAX bf16 loss + the JAX optimizer on the same
    batches: losses within 1e-3 relative, every master leaf within one
    bf16 ulp of its value (Adam divides the update by sqrt(v), so a
    gradient an ulp apart moves the parameter by at most ~lr)."""
    feats, w, nodes = _problem(4)
    batches = _batches(3, seed=5)
    jparams = jp.init_pinsage(jax.random.PRNGKey(2), L, IN, HID, OUT)
    tcfg, mcfg, jcfg = _cfgs()
    tx = j_make_optimizer(jcfg)
    opt_state = tx.init(jparams)
    params = _port_params(jparams)
    want_losses = []
    for batch in batches:
        loss, grads = jax.value_and_grad(_jax_bf16_loss_fn(
            feats, w, nodes, batch, tcfg.margin, False))(jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_losses.append(float(loss))
    opt = ttrainer.make_optimizer(params, tcfg)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T,
                                        dtype="bfloat16")
    metrics = [ttrainer.train_step(params, opt, torch.from_numpy(b), tables,
                                   tcfg, mcfg, fullgraph=False).numpy()
               for b in batches]
    np.testing.assert_allclose([m[0] for m in metrics], want_losses,
                               rtol=LOSS_RTOL)
    for (name, got), want in zip(params.leaves(), _jax_leaves(jparams)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=2 ** -7,
                                   atol=2 * tcfg.lr, err_msg=name)


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


def _losses(trainer):
    with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["Train Loss"] for line in f]


def test_bfloat16_training(port_graph, port_positives, tmp_path):
    """tests/test_trainer.py's bar on the port: finite losses that fall,
    f32 master weights."""
    tr = _trainer(port_graph, port_positives, tmp_path, "bf16",
                  **{"train.dtype": "bfloat16", "train.lr": 1e-3,
                     "train.margin": 0.1, "train.epochs": 2,
                     "train.batches_per_epoch": 30})
    tr.train()
    assert all(p.dtype == torch.float32 for _, p in tr.params.leaves())
    assert all(m.dtype == torch.float32 for m in tr.opt.m + tr.opt.v)
    losses = _losses(tr)
    assert len(losses) == 60 and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_bfloat16_fullgraph_training(port_graph, port_positives, tmp_path):
    """tests/test_trainer.py's bar on the port: bf16 with the full-graph
    forward converges, and its hit@100 is above 0.8 of the f32 run's."""
    common = {"train.lr": 1e-3, "train.margin": 0.1, "train.epochs": 2,
              "train.batches_per_epoch": 30,
              "train.fullgraph_forward": "on"}
    tr16 = _trainer(port_graph, port_positives, tmp_path, "bf16_fg",
                    **{"train.dtype": "bfloat16", **common})
    tr16.train()
    losses = _losses(tr16)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    tr32 = _trainer(port_graph, port_positives, tmp_path, "f32_fg", **common)
    tr32.train()

    def hit100(emb):
        _, nbr = knn_from_emb(emb, k=100, device="cpu")
        pos = port_positives
        return float((nbr[pos[:, 0]] == pos[:, 1][:, None]).any(1).mean())

    h16, h32 = hit100(tr16.embed()), hit100(tr32.embed())
    assert h16 > 0.8 * h32, (h16, h32)


def test_bf16_checkpoint_holds_f32_masters_and_resumes(
        port_graph, port_positives, tmp_path):
    """A bf16 run's state.npz holds the f32 master leaves under the JAX
    key paths (the JAX package's ``load_pytree`` reads them into its
    params), ``embed`` reads the f32 table and masters (an f32 trainer on
    the same state embeds the same bits), and a resumed run replays a
    continuous one."""
    kw = {"train.dtype": "bfloat16", "train.checkpoint_every_batches": 5}
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


def test_cli_train_in_bf16(tmp_path):
    """``train --set train.dtype="bfloat16"`` as the JAX CLI takes it: the
    run's config.json says bfloat16, emb.npy is finite, and a dtype that
    ``jnp.dtype`` refuses is refused."""
    ds = str(tmp_path / "ds")
    cli.main(["synth", "--dataset", ds, "--n-tracks", "150",
              "--n-collections", "40", "--n-positives", "500",
              "--feature-dim", "16", "--seed", "2"])
    runs = str(tmp_path / "runs")
    argv = ["train", "--dataset", ds, "--run-dir", runs, "--run-name", "b",
            "--device", "cpu", "--set", "train.epochs=1",
            "--set", "train.batches_per_epoch=3",
            "--set", "train.batch_size=8", "--set", "walk.n_hops=50",
            "--set", "model.hidden_dim=32", "--set", "model.out_dim=16",
            "--set", 'train.dtype="bfloat16"']
    cli.main(argv)
    run = os.path.join(runs, "b")
    with open(os.path.join(run, "config.json")) as f:
        assert RunConfig.from_json(f.read()).train.dtype == "bfloat16"
    emb = np.load(os.path.join(run, "emb.npy"))
    assert emb.shape == (150, 16) and np.isfinite(emb).all()
    with pytest.raises(ValueError, match="names no type"):
        cli.main(argv[:-1] + ['train.dtype="bf16"', "--no-resume"])
