"""The port's co-listen / hard-negative A/B module, on the CPU.

``gcn_song_embeddings_tpu_torch.colisten_ab`` is held to the JAX script
(``scripts/colisten_ab.py``, loaded from its path; it imports JAX only
inside ``main``):

* ``TUNED`` and ``ARMS`` equal the script's;
* every arm's config equals the one the script's ``main`` builds (its
  trainer replaced by a recorder), field for field, with and without
  ``--quick``;
* the curriculum gate flips at the JAX trainer's step, in one run and in
  a run cut short after a checkpoint and resumed;
* the PPR control arms' lists, walked under JAX's threefry uniforms,
  equal JAX's bit for bit (the padded tail block included), so their
  rows equal the script's;
* a ``--quick`` run writes one row per arm with the script's keys and
  rounding into its work dir, nothing on a rerun and nothing under
  ``results/``;
* the learning check: ppr_co1 / ppr_plain on hit@10 and co1_T10 /
  plain10 on hit@100 reach 0.8x the JAX script's own ratios on the same
  dataset and schedule.
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcn_song_embeddings_tpu.evals.device_eval as j_device_eval
import gcn_song_embeddings_tpu.models.baselines.mf as j_mf
import gcn_song_embeddings_tpu.train.trainer as j_trainer
import gcn_song_embeddings_tpu_torch.train.trainer as p_trainer
from gcn_song_embeddings_tpu.config import RunConfig as JRunConfig
from gcn_song_embeddings_tpu.config import (
    config_with_overrides as j_config_with_overrides,
)
from gcn_song_embeddings_tpu.data.device import DeviceGraph as JDeviceGraph
from gcn_song_embeddings_tpu.data.device import (
    augment_with_colisten as j_augment,
)
from gcn_song_embeddings_tpu.data.graph import SongGraph as JSongGraph
from gcn_song_embeddings_tpu.evals import metrics as JM
from gcn_song_embeddings_tpu.ops.ppr import (
    sample_neighborhood_topt_tables as j_topt_tables,
)
from gcn_song_embeddings_tpu.ops.walks import (
    fused_walk_tables as j_fused_tables,
)
from gcn_song_embeddings_tpu_torch import colisten_ab
from gcn_song_embeddings_tpu_torch.config import (
    config_with_overrides as p_config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.synth import ensure_hard_dataset
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RESULTS = os.path.join(REPO, "results", "colisten_ab.jsonl")
SIZE = ["--tracks", "2000", "--collections", "400", "--positives", "6000"]
PPR_ARMS = ["ppr_plain", "ppr_co1"]
E2E_ARMS = ["cf_bpr", "ppr_plain", "ppr_co1", "plain10", "co1_T10", "cur10"]
LEARNING = 0.8      # the port's ratio over JAX's own, at least
ARM_NAMES = [a for a, _ in colisten_ab.ARMS]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_script_colisten_ab", os.path.join(REPO, "scripts",
                                               "colisten_ab.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quiet(*_a, **_k):
    pass


def _work(root, name) -> str:
    """A work dir holding a copy of the shared dataset in ``ds``."""
    work = os.path.join(root, name)
    shutil.copytree(os.path.join(root, "shared", "ds"),
                    os.path.join(work, "ds"))
    return work


def _rows(path) -> dict:
    with open(path) as f:
        return {r["arm"]: r for r in map(json.loads, f)}


@pytest.fixture(scope="module")
def results_bytes():
    with open(JAX_RESULTS, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def root(tmp_path_factory, results_bytes) -> str:
    root = str(tmp_path_factory.mktemp("colisten_ab"))
    ensure_hard_dataset(os.path.join(root, "shared", "ds"), n_tracks=2000,
                        n_collections=400, n_positives=6000, seed=0,
                        log=_quiet)
    return root


@pytest.fixture(scope="module")
def jax_recorded(root):
    """The configs and rows of the JAX script's ``main`` with its
    trainer, CF model and ``rank_eval`` replaced by recorders, with and
    without ``--quick`` (every arm but the PPR controls)."""
    configs = {False: {}, True: {}}
    rows = {}
    mp = pytest.MonkeyPatch()

    class Trainer:
        def __init__(self, dg, n_items, features, positives, cfg, **kw):
            configs[mode][cfg.run_name] = cfg
            self.n = n_items

        def train(self):
            pass

        def embed(self, bsize=4096):
            return np.ones((self.n, 4), np.float32)

    class CF:
        def __init__(self, algo):
            self.model = type("M", (), {"item_factors": np.ones((2, 2))})

        def train(self, *a):
            pass

    metrics = {"hit@10": 0.123456789, "hit@100": 0.2, "hit@500": 0.3,
               "mrr@1000": 0.0456789}
    mp.setattr(j_trainer, "PinSageTrainer", Trainer)
    mp.setattr(j_mf, "TrackTrackCF", CF)
    mp.setattr(j_device_eval, "rank_eval", lambda *a, **k: dict(metrics))
    script = _jax_script()
    arms = ",".join(["cf_als", "cf_bpr"] + ARM_NAMES)
    try:
        for mode in (False, True):
            work = _work(root, f"jax_recorded_{mode}")
            out = os.path.join(work, "out.jsonl")
            mp.setattr("sys.argv", ["colisten_ab.py", "--work-dir", work,
                                    *SIZE, "--arms", arms, "--out", out]
                       + (["--quick"] if mode else []))
            script.main()
            rows[mode] = _rows(out)
    finally:
        mp.undo()
    return configs, rows


@pytest.fixture(scope="module")
def jax_run(root):
    """The JAX script's ``--quick`` run of the PPR controls and the two
    PinSage arms of the learning check, trained for real."""
    work = _work(root, "jax_run")
    out = os.path.join(work, "out.jsonl")
    mp = pytest.MonkeyPatch()
    mp.setattr("sys.argv", ["colisten_ab.py", "--work-dir", work, *SIZE,
                            "--quick", "--out", out, "--arms",
                            "ppr_plain,ppr_co1,plain10,co1_T10"])
    try:
        _jax_script().main()
    finally:
        mp.undo()
    return _rows(out)


@pytest.fixture(scope="module")
def port_run(root):
    """The port's ``--quick`` run of the end-to-end arms, then a rerun."""
    work = _work(root, "port_run")
    argv = ["--work-dir", work, *SIZE, "--quick", "--device", "cpu",
            "--arms", ",".join(E2E_ARMS)]
    first = colisten_ab.run(colisten_ab.parse_args(argv), log=_quiet)
    out = os.path.join(work, "colisten_ab.jsonl")
    with open(out, "rb") as f:
        written = f.read()
    again = colisten_ab.run(colisten_ab.parse_args(argv), log=_quiet)
    with open(out, "rb") as f:
        rewritten = f.read()
    return {"work": work, "out": out, "first": first, "again": again,
            "written": written, "rewritten": rewritten}


def test_tuned_and_arms_equal_jax():
    script = _jax_script()
    assert colisten_ab.TUNED == script.TUNED
    assert colisten_ab.ARMS == script.ARMS
    assert len(colisten_ab.ARMS) == 17


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
@pytest.mark.parametrize("arm", ARM_NAMES)
def test_arm_config_equals_jax(jax_recorded, arm, quick):
    overrides = dict(colisten_ab.ARMS)[arm]
    got = colisten_ab.arm_config(arm, overrides, quick)
    want = jax_recorded[0][quick][arm]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not quick:
        plain = j_config_with_overrides(JRunConfig(run_name=arm),
                                        {**colisten_ab.TUNED, **overrides})
        assert dataclasses.asdict(got) == dataclasses.asdict(plain)
    tcfg = got.train
    if "train.hn_start_epoch" in overrides:
        # the gated-hard phase runs inside the (shrunk) schedule
        assert 0 < tcfg.hn_start_epoch < tcfg.epochs


@pytest.fixture(scope="module")
def gate_recorders():
    """``sample_batch`` of both trainers wrapped to record each step's
    curriculum gate into ``sink["jax"]`` / ``sink["port"]`` (JAX's through
    an ordered debug callback: its gate is traced in the scan)."""
    sink = {"jax": [], "port": []}
    j_sample, p_sample = j_trainer.sample_batch, p_trainer.sample_batch

    def j_wrapped(*a, hn_gate=None, **kw):
        if hn_gate is not None:
            jax.debug.callback(lambda g: sink["jax"].append(bool(g)),
                               hn_gate, ordered=True)
        return j_sample(*a, hn_gate=hn_gate, **kw)

    def p_wrapped(*a, hn_gate=None, **kw):
        if hn_gate is not None:
            sink["port"].append(bool(hn_gate))
        return p_sample(*a, hn_gate=hn_gate, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_trainer, "sample_batch", j_wrapped)
    mp.setattr(p_trainer, "sample_batch", p_wrapped)
    yield sink
    mp.undo()


def _gate_run(pkg, root, name, cfg, crash_after=None) -> list:
    """The gates of one training of ``cfg``; with ``crash_after``, the run
    raises after that many checkpoints and a new trainer resumes it."""
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph

    ds = os.path.join(root, "shared", "ds")
    g_cls, dg_cls, tr_cls = ((JSongGraph, JDeviceGraph,
                              j_trainer.PinSageTrainer) if pkg == "jax"
                             else (SongGraph, DeviceGraph,
                                   p_trainer.PinSageTrainer))
    g = g_cls(ds, features_file=os.path.join(ds, "features.npy"))
    dg = (dg_cls.from_graph(g) if pkg == "jax"
          else dg_cls.from_graph(g, "cpu"))
    train_pos, _ = g.load_positives_split(os.path.join(ds,
                                                       "positives.json"))
    runs = os.path.join(root, f"gate_{pkg}_{name}")

    def trainer():
        return tr_cls(dg, g.n_items, g.features, train_pos, cfg=cfg,
                      base_run_dir=runs,
                      nbhds_path=os.path.join(runs, "nbhds.npz"), log=False,
                      load_save=True, verbose=False)

    first = trainer()
    if crash_after is not None:
        saves = []
        save = first.save_model

        def crashing():
            save()
            saves.append(1)
            if len(saves) == crash_after:
                raise KeyboardInterrupt("cut short")

        first.save_model = crashing
        with pytest.raises(KeyboardInterrupt):
            first.train()
        first = trainer()
        assert first.e * cfg.train.batches_per_epoch + first.b == (
            crash_after * cfg.train.checkpoint_every_batches)
    first.train()


@pytest.mark.parametrize("crash_after", [None, 1, 3],
                         ids=["continuous", "resumed_before", "resumed_after"])
def test_curriculum_gate_flips_at_jax_step(root, gate_recorders,
                                           crash_after):
    # cur10 in --quick form (2 x 30, hard from epoch 1) in chunks of 12,
    # so the flip at step 30 falls inside a chunk; B=16 on the small graph
    overrides = dict(colisten_ab.ARMS)["cur10"]
    cfg = colisten_ab.arm_config("cur10", overrides, quick=True)
    assert (cfg.train.epochs, cfg.train.batches_per_epoch,
            cfg.train.hn_start_epoch) == (2, 30, 1)
    extra = {"train.checkpoint_every_batches": 12, "train.batch_size": 16}
    p_cfg = p_config_with_overrides(cfg, extra)
    j_cfg = j_config_with_overrides(JRunConfig.from_json(cfg.to_json()),
                                    extra)
    name = str(crash_after)
    for pkg, run_cfg in (("jax", j_cfg), ("port", p_cfg)):
        gate_recorders[pkg].clear()
        _gate_run(pkg, root, name, run_cfg, crash_after)
    want = [False] * 30 + [True] * 30
    assert gate_recorders["jax"] == want
    assert gate_recorders["port"] == gate_recorders["jax"]


def _jax_block_uniforms(start: int, hops: int, block: int) -> torch.Tensor:
    """The script's block draws: ``fold_in(PRNGKey(0), start)``'s
    [hops, block, 3] uniforms."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), start)
    return torch.tensor(np.asarray(jax.random.uniform(key,
                                                      (hops, block, 3))))


def _port_data(root):
    args = colisten_ab.parse_args(["--work-dir", os.path.join(root, "shared"),
                                   *SIZE, "--device", "cpu"])
    return colisten_ab.load(args, torch.device("cpu"), log=_quiet)


@pytest.mark.parametrize("copies", [0, 1], ids=PPR_ARMS)
def test_ppr_lists_equal_jax_in_padded_blocks(root, copies):
    # three blocks of 768 over 2,000 tracks: the last holds 464 origins
    # and 304 copies of its last id
    data = _port_data(root)
    hops, k, block = 60, 80, 768
    got = colisten_ab.ppr_lists(
        colisten_ab.ppr_arm_graph(data, copies), data.graph.n_items, k=k,
        block=block, hops=hops,
        uniforms=lambda s: _jax_block_uniforms(s, hops, block))
    jg = JSongGraph(data.ds_path, features_file=os.path.join(
        data.ds_path, "features.npy"))
    jdg = JDeviceGraph.from_graph(jg)
    if copies:
        jdg = j_augment(jdg, data.train_pos, copies)
    tables = j_fused_tables(jdg)
    n = jg.n_items
    want = np.zeros((n, k), np.int32)
    key = jax.random.PRNGKey(0)
    for s in range(0, n, block):
        e = min(s + block, n)
        ids = np.full((block,), e - 1, np.int32)
        ids[:e - s] = np.arange(s, e, dtype=np.int32)
        _, nodes = j_topt_tables(tables, jnp.asarray(ids), hops, 0.85, k,
                                 jax.random.fold_in(key, s))
        want[s:e] = np.asarray(nodes)[:e - s]
    np.testing.assert_array_equal(got, want)
    m = colisten_ab.knn_list_metrics(got, data.test_pos)
    jm = {f"hit@{K}": JM.hit_rate(want, data.test_pos, K)
          for K in (10, 100, 500)}
    jm["mrr@1000"] = JM.mrr(want, data.test_pos, 1000)
    assert m == jm


@pytest.mark.parametrize("arm", PPR_ARMS)
def test_ppr_rows_equal_the_jax_script(root, jax_run, arm):
    # the script's own shapes (1000 hops, top 1000, one padded block of
    # 2,048 over 2,000 tracks) under its uniforms: the same row
    data = _port_data(root)
    copies = dict(colisten_ab.PPR_ARMS)[arm]
    knn = colisten_ab.ppr_lists(
        colisten_ab.ppr_arm_graph(data, copies), data.graph.n_items,
        uniforms=lambda s: _jax_block_uniforms(s, 1000, 2048))
    m = colisten_ab.knn_list_metrics(knn, data.test_pos)
    want = jax_run[arm]
    assert {k: round(v, 5) for k, v in m.items()} == {
        k: want[k] for k in m}


def test_quick_run_rows_keys_and_rounding(port_run, jax_recorded, jax_run):
    rows = _rows(port_run["out"])
    # the script's order: CF rows, PPR controls, then ARMS
    order = ["cf_als", "cf_bpr", *PPR_ARMS, *ARM_NAMES]
    assert list(rows) == [a for a in order if a in E2E_ARMS]
    assert set(port_run["first"]) == set(E2E_ARMS)
    jax_rows = {**jax_recorded[1][True], **jax_run}
    for arm, row in rows.items():
        assert list(row) == list(jax_rows[arm]), arm
        for key, value in row.items():
            if key.startswith(("hit@", "mrr@")):
                assert value == round(value, 5) and 0 <= value <= 1
            elif key.endswith("_s"):
                assert value == round(value, 1) and value >= 0
        if arm in dict(colisten_ab.ARMS):
            assert row["overrides"] == jax_rows[arm]["overrides"]
        if arm in PPR_ARMS:
            assert row["evaluator"] == "knn_list"
    # the recorder's metric rounding, as the script rounds
    assert jax_recorded[1][False]["plain30"]["hit@10"] == 0.12346


def test_rerun_writes_nothing(port_run):
    assert port_run["again"] == {}
    assert port_run["rewritten"] == port_run["written"]


def test_writes_only_under_the_work_dir(port_run, results_bytes):
    work = port_run["work"]
    assert sorted(os.listdir(work)) == ["colisten_ab.jsonl", "ds", "runs"]
    assert sorted(os.listdir(os.path.join(work, "runs"))) == sorted(
        a for a in E2E_ARMS if a in dict(colisten_ab.ARMS))
    with open(JAX_RESULTS, "rb") as f:
        assert f.read() == results_bytes


def test_unparsable_lines_are_ignored(tmp_path):
    path = tmp_path / "ab.jsonl"
    path.write_text('{"arm": "co1"}\nnot json\n{"no_arm": 1}\n[1, 2]\n'
                    '{"arm": "cf_als", "hit@10": 0.1}\n')
    assert colisten_ab.done_arms(str(path)) == {"co1", "cf_als"}
    assert colisten_ab.done_arms(str(tmp_path / "none.jsonl")) == set()


@pytest.mark.parametrize("num,den,metric", [
    ("ppr_co1", "ppr_plain", "hit@10"),
    ("co1_T10", "plain10", "hit@100")], ids=["ppr", "pinsage"])
def test_learning_check_against_jax_ratio(port_run, jax_run, num, den,
                                          metric):
    rows = _rows(port_run["out"])
    got = rows[num][metric] / rows[den][metric]
    want = jax_run[num][metric] / jax_run[den][metric]
    assert want > 2.0, (jax_run[num], jax_run[den])
    assert got >= LEARNING * want, (got, want, rows[num], rows[den])


@pytest.mark.parametrize("arm", ["co1_T10_wide", "co1_T10_d512"])
def test_the_wide_arms_model_matches_jax(arm):
    """The wide arms' model (in 128, hidden 1024, out 256 or 512, T=10,
    two layers) from JAX's initial parameters on the same tables: the
    frontier embeddings of a [3B] batch within 1e-5 of the JAX package's,
    and at the arms' margin (1e-5) the loss within 1e-6 and every
    gradient within rtol 1e-4 / atol 1e-5 of ``jax.value_and_grad``'s
    (tests/test_torch_train.py's bars).  At that margin the loss is a
    difference of near-equal cosines and its gradients are ~1e-7, so
    Adam scales their f32 rounding to a share of lr: two f32 evaluation
    orders part after one step, and no trajectory bar holds."""
    import gcn_song_embeddings_tpu.models.pinsage as jp
    from gcn_song_embeddings_tpu.train import loss as jloss
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        forward_with_gather,
        packed_nbhd_gather,
    )
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
        params_from_numpy,
    )

    cfg = colisten_ab.arm_config(arm, dict(colisten_ab.ARMS)[arm])
    mcfg, L, T = cfg.model, cfg.model.n_layers, cfg.model.T
    assert (mcfg.hidden_dim, L, T, cfg.train.margin) == (1024, 2, 10, 1e-5)
    n, d_in, b = 400, 128, 8
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(n, d_in)).astype(np.float32)
    w = np.ascontiguousarray(np.sort(rng.random((n, T)).astype(np.float32),
                                     axis=1)[:, ::-1])
    nodes = rng.integers(0, n, (n, T)).astype(np.int32)
    batch = rng.integers(0, n, (b, 3)).astype(np.int32)
    jparams = jp.init_pinsage(jax.random.PRNGKey(0), L, d_in,
                              mcfg.hidden_dim, mcfg.out_dim)
    packed = jp.pack_nbhds(jnp.asarray(w), jnp.asarray(nodes), T)
    ids = np.concatenate([batch[:, 0], batch[:, 1], batch[:, 2]])

    def j_forward(p):
        return jp.forward_with_gather(
            p, lambda i: jnp.asarray(feats)[i],
            jp.packed_nbhd_gather(packed, T), jnp.asarray(ids), L, T)

    def j_loss(p):
        return jloss.max_margin_loss(*jnp.split(j_forward(p), 3, axis=0),
                                     cfg.train.margin)

    want_loss, want_grads = jax.value_and_grad(j_loss)(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tables = p_trainer.TrainTables.build(feats, w, nodes, T)
    emb = forward_with_gather(
        params, lambda i: tables.features[i.long()],
        packed_nbhd_gather(tables.packed, T), torch.from_numpy(ids), L, T)
    np.testing.assert_allclose(emb.detach().numpy(),
                               np.asarray(j_forward(jparams)),
                               rtol=1e-5, atol=1e-5)
    tcfg = dataclasses.replace(cfg.train, batch_size=b)
    loss, _ = p_trainer.triple_loss(params, tables, torch.from_numpy(batch),
                                    tcfg, mcfg, False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6)
    grads = torch.autograd.grad(loss, [p for _, p in params.leaves()])
    jl = want_grads.layers
    want = ([getattr(jl[i], f) for i in range(L)
             for f in ("Wq", "bq", "Ww", "bw")]
            + [want_grads.G1_w, want_grads.G1_b, want_grads.G2_w])
    for g, wg in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4,
                                   atol=1e-5)
