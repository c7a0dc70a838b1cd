"""Port's training slice (loss, sampler, Adam, train step, trainer, CLI
``train``) vs the JAX package, on the CPU at a small size.

Inputs are made from a seed with numpy and handed to both packages;
params are made by the JAX package's ``init_pinsage`` and carried across
with ``params_from_numpy``.  Tolerances: 1e-6 for the losses (f32, a few
reductions), atol 1e-5 / rtol 1e-4 for gradients and 3-step trajectories
(the JAX suite's own tolerance for two forwards that reassociate f32
sums, tests/test_trainer.py), atol 1e-7 for Adam fed identical gradients.
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
from gcn_song_embeddings_tpu.train import loss as jloss
from gcn_song_embeddings_tpu.train.trainer import (
    make_optimizer as j_make_optimizer,
)
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.config import (
    PinSageConfig,
    RunConfig,
    TrainConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.train import loss as tloss
from gcn_song_embeddings_tpu_torch.train import trainer as ttrainer
from gcn_song_embeddings_tpu_torch.train.adam import Adam
from gcn_song_embeddings_tpu_torch.train.sampler import sample_batch
from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
    load_jax_checkpoint,
    load_state,
    params_from_numpy,
    params_to_numpy,
    save_state,
)

N, IN, HID, OUT, L, T, B = 300, 16, 32, 16, 2, 3, 8
TRAJ = dict(rtol=1e-4, atol=1e-5)


def _jax_params(seed=0):
    return jp.init_pinsage(jax.random.PRNGKey(seed), L, IN, HID, OUT)


def _leaves(tree):
    """Flat list of numpy leaves in ``PinSageParams.leaves()`` order."""
    return ([layer[f] for layer in tree["layers"]
             for f in ("Wq", "bq", "Ww", "bw")]
            + [tree[f] for f in ("G1_w", "G1_b", "G2_w")])


def _jax_leaves(params):
    return _leaves({"layers": [layer._asdict() for layer in params.layers],
                    "G1_w": params.G1_w, "G1_b": params.G1_b,
                    "G2_w": params.G2_w})


def _port_leaves(params):
    return [p for _, p in params.leaves()]


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, IN)).astype(np.float32)
    w = np.sort(rng.random((N, T + 2)).astype(np.float32), axis=1)[:, ::-1]
    w[::7, T - 1:] = 0.0                   # zero-weight tails
    w[5] = 0.0                             # an all-zero neighborhood
    nodes = rng.integers(0, N, (N, T + 2)).astype(np.int32)
    return feats, np.ascontiguousarray(w), nodes


def _batches(k, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, N, (B, 3)).astype(np.int32) for _ in range(k)]


def _cfgs(**train):
    kw = dict(lr=1e-3, margin=0.1, batch_size=B, batches_per_epoch=2,
              decay=0.5, **train)
    return (TrainConfig(**kw), PinSageConfig(in_dim=IN, hidden_dim=HID,
                                             out_dim=OUT, n_layers=L, T=T),
            JRunConfig(train=JTrainConfig(**kw),
                       model=JPinSageConfig(in_dim=IN, hidden_dim=HID,
                                            out_dim=OUT, n_layers=L, T=T)))


def _jax_loss_fn(feats, w, nodes, batch, margin):
    packed = jp.pack_nbhds(jnp.asarray(w), jnp.asarray(nodes), T)
    f = jnp.asarray(feats)
    b = jnp.asarray(batch)

    def loss_fn(params):
        emb = jp.forward_with_gather(
            params, lambda ids: f[ids], jp.packed_nbhd_gather(packed, T),
            jnp.concatenate([b[:, 0], b[:, 1], b[:, 2]]), L, T)
        h_q, h_pos, h_neg = jnp.split(emb, 3, axis=0)
        return jloss.max_margin_loss(h_q, h_pos, h_neg, margin)
    return loss_fn


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    q, p, n = (rng.normal(size=(20, OUT)).astype(np.float32)
               for _ in range(3))
    n[4] = 0.0                             # clamped norm (eps 1e-12)
    q[7] = 0.0                             # clamped cosine (eps 1e-8)
    tq, tp_, tn = (torch.from_numpy(a) for a in (q, p, n))
    jq, jp_, jn = (jnp.asarray(a) for a in (q, p, n))
    for margin in (0.1, 1e-5):
        np.testing.assert_allclose(
            float(tloss.max_margin_loss(tq, tp_, tn, margin)),
            float(jloss.max_margin_loss(jq, jp_, jn, margin)), atol=1e-6)
    np.testing.assert_allclose(float(tloss.cosine_triplet_loss(tq, tp_, tn)),
                               float(jloss.cosine_triplet_loss(jq, jp_, jn)),
                               atol=1e-6)
    np.testing.assert_allclose(float(tloss.batch_variance(tq)),
                               float(jloss.batch_variance(jq)), rtol=1e-6)


@pytest.mark.parametrize("fullgraph", [False, True])
def test_loss_and_grads_match_jax(fullgraph):
    """One fixed batch, the same params: the port's loss and every grad
    (frontier forward, and the full-graph forward) vs jax.value_and_grad
    of the JAX package's frontier forward + max-margin loss."""
    feats, w, nodes = _problem()
    batch = _batches(1)[0]
    jparams = _jax_params()
    tcfg, mcfg, _ = _cfgs()
    want_loss, want_grads = jax.value_and_grad(
        _jax_loss_fn(feats, w, nodes, batch, tcfg.margin))(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tables = ttrainer.TrainTables.build(feats, w, nodes, T)
    loss, _ = ttrainer.triple_loss(params, tables, torch.from_numpy(batch),
                                   tcfg, mcfg, fullgraph)
    grads = torch.autograd.grad(loss, _port_leaves(params))
    assert float(loss.detach()) > 0.0
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6)
    for g, want in zip(grads, _jax_leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TRAJ)


def test_adam_matches_optax_across_a_decay_boundary():
    """The same numpy grads into the port's Adam and the JAX package's
    make_optimizer (optax adam + staircase decay, 2 batches per epoch,
    decay 0.5) for 3 steps: the third crosses the boundary."""
    jparams = _jax_params(1)
    _, _, jcfg = _cfgs()
    tx = j_make_optimizer(jcfg)
    opt_state = tx.init(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    opt = Adam(_port_leaves(params), 1e-3, 0.5, 2)
    rng = np.random.default_rng(2)
    rates = []
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                                  * 0.1), jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        rates.append(opt.rate())
        opt.step([torch.tensor(np.asarray(g)) for g in _jax_leaves(grads)])
    assert rates == [1e-3, 1e-3, 5e-4] and opt.count == 3
    for got, want in zip(_port_leaves(params), _jax_leaves(jparams)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-7)


def test_three_step_trajectory_matches_jax():
    """train_step x 3 on a fixed batch sequence vs value_and_grad + the
    JAX optimizer on the same sequence."""
    feats, w, nodes = _problem(4)
    batches = _batches(3, seed=5)
    jparams = _jax_params(2)
    tcfg, mcfg, jcfg = _cfgs()
    tx = j_make_optimizer(jcfg)
    opt_state = tx.init(jparams)
    want_losses = []
    for batch in batches:
        loss, grads = jax.value_and_grad(
            _jax_loss_fn(feats, w, nodes, batch, tcfg.margin))(jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_losses.append(float(loss))
    params = params_from_numpy(_numpy(_jax_params(2)))
    opt = ttrainer.make_optimizer(params, tcfg)
    tables = ttrainer.TrainTables.build(feats, w, nodes, T)
    metrics = [ttrainer.train_step(params, opt, torch.from_numpy(b), tables,
                                   tcfg, mcfg, fullgraph=False).numpy()
               for b in batches]
    np.testing.assert_allclose([m[0] for m in metrics], want_losses, **TRAJ)
    assert [float(m[3]) for m in metrics] == pytest.approx(
        [1e-3, 1e-3, 5e-4])
    for got, want in zip(_port_leaves(params), _jax_leaves(jparams)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TRAJ)


def _numpy(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


def test_params_to_numpy_round_trip():
    jparams = _numpy(_jax_params(3))
    tree = params_to_numpy(params_from_numpy(jparams))
    for got, want in zip(_leaves(tree), _jax_leaves(jparams)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- sampler

def _sampler_inputs(seed=0):
    rng = np.random.default_rng(seed)
    positives = torch.from_numpy(
        rng.integers(0, N, (500, 2)).astype(np.int32))
    nbhd_n = torch.from_numpy(rng.integers(0, N, (N, 60)).astype(np.int32))
    return positives, nbhd_n


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sampler_hard_negative_ranks():
    positives, nbhd_n = _sampler_inputs()
    batch = sample_batch(_gen(0), positives, nbhd_n, 64, N,
                         hard_negatives=True, hn_min=5, hn_max=50).numpy()
    assert batch.shape == (64, 3) and batch.dtype == np.int32
    for q, _, n in batch:
        assert n in nbhd_n.numpy()[q, 5:50]


def test_sampler_easy_negative_avoids_batch():
    positives, nbhd_n = _sampler_inputs(1)
    batch = sample_batch(_gen(1), positives, nbhd_n, 64, N).numpy()
    batch_nodes = set(batch[:, :2].reshape(-1).tolist())
    # two rejection rounds leave a vanishing collision probability
    assert sum(int(n) in batch_nodes for n in batch[:, 2]) <= 2
    assert ((batch >= 0) & (batch < N)).all()


def test_sampler_gate_and_exact_rows():
    positives, nbhd_n = _sampler_inputs(2)
    kw = dict(positives=positives, nbhd_nodes=nbhd_n, batch_size=64,
              n_items=N, hn_min=5, hn_max=50)
    easy = sample_batch(_gen(7), hard_negatives=False, **kw)
    gated_off = sample_batch(_gen(7), hard_negatives=True, hn_gate=False,
                             **kw)
    gated_on = sample_batch(_gen(7), hard_negatives=True, hn_gate=True,
                            **kw).numpy()
    assert torch.equal(gated_off, easy)
    for q, _, n in gated_on:
        assert n in nbhd_n.numpy()[q, 5:50]
    # exact=True: distinct positive rows within the batch
    pos = torch.arange(200, dtype=torch.int32)[:, None].repeat(1, 2)
    rows = sample_batch(_gen(3), pos, nbhd_n, 150, N, exact=True)[:, 0]
    assert len(set(rows.tolist())) == 150


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def port_graph(dataset_dir):
    return SongGraph(dataset_dir,
                     features_file=os.path.join(dataset_dir, "features.npy"))


@pytest.fixture(scope="module")
def port_positives(port_graph, dataset_dir):
    return port_graph.load_positives(
        os.path.join(dataset_dir, "positives.json"))


def _trainer(graph, positives, base, run_name="t", **over):
    overrides = {"train.epochs": 2, "train.batches_per_epoch": 10,
                 "train.batch_size": 32, "walk.n_hops": 100,
                 "walk.batch_walkers": 256, "train.lr": 1e-3,
                 "train.margin": 0.1}
    overrides.update(over)
    cfg = config_with_overrides(RunConfig(run_name=run_name), overrides)
    return ttrainer.PinSageTrainer(
        DeviceGraph.from_graph(graph, "cpu"), graph.n_items, graph.features,
        positives, cfg=cfg, base_run_dir=str(base),
        nbhds_path=os.path.join(str(base), "nbhds.npz"), log=True,
        load_save=True, verbose=False)


def _rows(trainer):
    with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_chunks_span_epochs_metrics_and_resume(port_graph, port_positives,
                                               tmp_path):
    """Chunks of 4 batches cross the epoch boundary at 10; one JSONL row
    per batch with the JAX field names; the rate steps x0.95 at the
    boundary; a fresh trainer resumes the finished state."""
    tr = _trainer(port_graph, port_positives, tmp_path,
                  **{"train.checkpoint_every_batches": 4})
    tr.train()
    assert (tr.e, tr.b, tr.opt.count) == (2, 0, 20)
    rows = _rows(tr)
    assert len(rows) == 20
    assert set(rows[0]) == set(ttrainer.METRICS) | {"epoch"}
    assert [r["epoch"] for r in rows] == [0] * 10 + [1] * 10
    assert all(np.isfinite(r["Train Loss"]) for r in rows)
    assert 0 < rows[0]["Gradient Norm"] < 1e6
    lrs = [r["Learning Rate"] for r in rows]
    np.testing.assert_allclose(lrs[:10], 1e-3, rtol=1e-6)
    np.testing.assert_allclose(lrs[10:], 1e-3 * 0.95, rtol=1e-6)

    tr2 = _trainer(port_graph, port_positives, tmp_path,
                   **{"train.checkpoint_every_batches": 4})
    assert (tr2.e, tr2.b, tr2.opt.count) == (2, 0, 20)
    np.testing.assert_allclose(tr.embed(ids=np.arange(16)),
                               tr2.embed(ids=np.arange(16)), atol=1e-6)
    np.testing.assert_allclose(tr.embed()[:16], tr2.embed(ids=np.arange(16)),
                               atol=1e-5)


def test_resume_replays_a_continuous_run(port_graph, port_positives,
                                         tmp_path):
    """1 epoch, then a new trainer resuming to 2 epochs, ends exactly
    where one continuous 2-epoch run ends (chunk generators seeded from
    the global batch index)."""
    kw = {"train.checkpoint_every_batches": 5}
    full = _trainer(port_graph, port_positives, tmp_path / "a", "r", **kw)
    full.train()
    half = _trainer(port_graph, port_positives, tmp_path / "b", "r",
                    **{**kw, "train.epochs": 1})
    half.train()
    resumed = _trainer(port_graph, port_positives, tmp_path / "b", "r", **kw)
    assert (resumed.e, resumed.b) == (1, 0)
    resumed.train()
    for a, b in zip(full.params.parameters(), resumed.params.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    assert len(_rows(resumed)) == 20


def test_fullgraph_forward_training_equivalence(port_graph, port_positives,
                                                tmp_path):
    """fullgraph_forward "on" and "off" train the same 3 steps."""
    kw = {"train.epochs": 1, "train.batches_per_epoch": 3}
    a = _trainer(port_graph, port_positives, tmp_path / "a", "fg",
                 **{**kw, "train.fullgraph_forward": "off"})
    b = _trainer(port_graph, port_positives, tmp_path / "b", "fg",
                 **{**kw, "train.fullgraph_forward": "on"})
    assert (a.fullgraph, b.fullgraph) == (False, True)
    a.train()
    b.train()
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   **TRAJ)


def test_trainer_refuses_bf16_and_bad_hn_band(port_graph, port_positives,
                                              tmp_path):
    """A train.dtype that the JAX trainer's ``jnp.dtype`` refuses too
    ("bf16"; bf16 and f16 training are held to JAX in
    tests/test_torch_bf16.py and tests/test_torch_f16.py), and a
    hard-negative band past the stored neighborhood ranks."""
    with pytest.raises(TypeError):
        jnp.dtype("bf16")
    with pytest.raises(ValueError, match="names no type"):
        _trainer(port_graph, port_positives, tmp_path,
                 **{"train.dtype": "bf16"})
    with pytest.raises(ValueError, match="t_precompute"):
        _trainer(port_graph, port_positives, tmp_path,
                 **{"train.hard_negatives": True, "train.hn_max": 101})


def test_hard_negative_curriculum_trains(port_graph, port_positives,
                                         tmp_path):
    tr = _trainer(port_graph, port_positives, tmp_path, "hn",
                  **{"train.hard_negatives": True, "train.hn_min": 5,
                     "train.hn_max": 50, "train.hn_start_epoch": 1,
                     "train.batches_per_epoch": 4})
    tr.train()
    assert tr.e == 2 and len(_rows(tr)) == 8


def test_state_checkpoint_round_trip_and_jax_key_paths(tmp_path):
    jparams = _numpy(_jax_params(4))
    params = params_from_numpy(jparams)
    opt = Adam(_port_leaves(params), 1e-3, 0.95, 10)
    opt.step([torch.ones_like(p) for p in opt.params])
    path = str(tmp_path / "state.npz")
    save_state(path, params, opt, {"epochs_done": 1, "batches_done": 3})
    with np.load(path) as z:
        assert "['params'].layers[1].Ww" in z.files
    # the params part reads as a JAX-layout checkpoint
    for a, b in zip(load_jax_checkpoint(path).parameters(),
                    params.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    fresh = params_from_numpy(_numpy(_jax_params(5)))
    opt2 = Adam(_port_leaves(fresh), 1e-3, 0.95, 10)
    scalars = load_state(path, fresh, opt2)
    assert scalars == {"epochs_done": 1.0, "batches_done": 3.0}
    assert opt2.count == 1
    for x, y in zip(opt.m + opt.v + list(params.parameters()),
                    opt2.m + opt2.v + list(fresh.parameters())):
        np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy())
    small = params_from_numpy(
        _numpy(jp.init_pinsage(jax.random.PRNGKey(0), L, IN, HID + 4, OUT)))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, small, Adam(_port_leaves(small), 1e-3, 0.95, 10))


def test_cli_train_then_embed_from_its_checkpoint(tmp_path):
    ds = str(tmp_path / "ds")
    cli.main(["synth", "--dataset", ds, "--n-tracks", "150",
              "--n-collections", "40", "--n-positives", "500",
              "--feature-dim", "16", "--seed", "2"])
    runs = str(tmp_path / "runs")
    cli.main(["train", "--dataset", ds, "--run-dir", runs, "--run-name",
              "c", "--device", "cpu", "--set", "train.epochs=1",
              "--set", "train.batches_per_epoch=3",
              "--set", "train.batch_size=8", "--set", "walk.n_hops=50",
              "--set", "model.hidden_dim=32", "--set", "model.out_dim=16"])
    run = os.path.join(runs, "c")
    emb = np.load(os.path.join(run, "emb.npy"))
    assert emb.shape == (150, 16) and np.isfinite(emb).all()
    with open(os.path.join(run, "config.json")) as f:
        cfg = RunConfig.from_json(f.read())
    assert (cfg.run_name, cfg.train.batches_per_epoch) == ("c", 3)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 3
    # a resumed `train` finds the run finished and rewrites the same emb
    cli.main(["train", "--dataset", ds, "--run-dir", runs, "--run-name",
              "c", "--device", "cpu", "--set", "train.epochs=1",
              "--set", "train.batches_per_epoch=3",
              "--set", "train.batch_size=8", "--set", "walk.n_hops=50",
              "--set", "model.hidden_dim=32", "--set", "model.out_dim=16"])
    np.testing.assert_array_equal(np.load(os.path.join(run, "emb.npy")), emb)
    # `embed --checkpoint` reads the port's own trainer state under the
    # run's config.json (RunConfig(), T=3), and gives the run's emb.npy
    out = str(tmp_path / "emb_ckpt.npy")
    cli.main(["embed", "--dataset", ds, "--out", out, "--checkpoint",
              os.path.join(run, "state.npz"), "--device", "cpu"])
    np.testing.assert_allclose(np.load(out), emb, atol=1e-5)


def test_cli_embed_sweeps_as_the_run_trained(tmp_path):
    """A co-listen run (walk.colisten_copies=1) on a dataset with both
    positives files: `embed --checkpoint` augments with the same
    positives_lfm.json pairs under the same walk config, so its output
    is the run's emb.npy; no checkpoint keeps RunConfig.recommended()."""
    ds = str(tmp_path / "ds")
    cli.main(["synth", "--dataset", ds, "--n-tracks", "160",
              "--n-collections", "40", "--n-positives", "600",
              "--feature-dim", "12", "--seed", "4"])
    with open(os.path.join(ds, "positives.json")) as f:
        pairs = json.load(f)
    with open(os.path.join(ds, "positives_lfm.json"), "w") as f:
        json.dump(pairs[::3], f)
    runs = str(tmp_path / "runs")
    cli.main(["train", "--dataset", ds, "--run-dir", runs, "--run-name",
              "co", "--device", "cpu", "--set", "train.epochs=1",
              "--set", "train.batches_per_epoch=2",
              "--set", "train.batch_size=8", "--set", "walk.n_hops=40",
              "--set", "walk.colisten_copies=1", "--set", "model.T=4",
              "--set", "model.hidden_dim=16", "--set", "model.out_dim=8"])
    run = os.path.join(runs, "co")
    for cache in os.listdir(ds):           # embed must sweep on its own
        if cache.endswith(".npz"):
            os.remove(os.path.join(ds, cache))
    emb = cli.embed_dataset(ds, os.path.join(run, "state.npz"),
                            device="cpu")
    np.testing.assert_allclose(emb, np.load(os.path.join(run, "emb.npy")),
                               atol=1e-5)
    assert cli.checkpoint_config(None) == RunConfig.recommended()
    assert cli.checkpoint_config(os.path.join(run, "state.npz")).model.T == 4


def test_deterministic_training(port_graph, port_positives, tmp_path):
    """Same seed and config -> identical parameters."""
    kw = {"train.epochs": 1, "train.batches_per_epoch": 4}
    a = _trainer(port_graph, port_positives, tmp_path / "a", "d", **kw)
    b = _trainer(port_graph, port_positives, tmp_path / "b", "d", **kw)
    a.train()
    b.train()
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy())
