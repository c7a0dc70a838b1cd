"""The port's ``fullgraph_bench`` against the JAX script, on the CPU.

``gcn_song_embeddings_tpu_torch.fullgraph_bench`` is held to
``scripts/fullgraph_bench.py``:

* ``edges_per_step`` equals the script's (its nested function, read by
  ``ast`` and run with the script's L=2, T=3);
* its data are the script's draws (the same numpy calls, in order);
* a run at a small catalog writes the script's keys (``B{B}_{off,on}_ms``
  and ``_Medges_s``, ``embed1m_*`` unless ``--skip-embed``) plus
  ``auto_picks_winner``, one verdict a batch size that follows
  ``fullgraph_wins`` and the measured times, and ``platform``;
* the ``off`` (frontier) and ``on`` (full-graph) steps of the trainer's
  chunk, from the same parameters on the same batches, give the same
  losses and parameters within tests/test_trainer.py's 3-step bar
  (rtol 1e-4, atol 1e-5).
"""

import ast
import copy
import json
import os

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch import fullgraph_bench as fb
from gcn_song_embeddings_tpu_torch.models.pinsage import fullgraph_wins
from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
from gcn_song_embeddings_tpu_torch.train.trainer import (
    TrainTables,
    make_optimizer,
    sample_train_batch,
    train_step,
)
from torch_capstone import REPO, script_tree
from torch_threads import one_torch_thread  # noqa: F401

TRAJ = {"rtol": 1e-4, "atol": 1e-5}
SMALL = ["--tracks", "600", "--batches", "16", "64", "--chunk-small", "1",
         "--chunk-large", "2", "--embed-tracks", "3000", "--device", "cpu"]


def _jax_main() -> ast.FunctionDef:
    return next(n for n in script_tree("fullgraph_bench").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_edges_per_step():
    fn = next(n for n in ast.walk(_jax_main())
              if isinstance(n, ast.FunctionDef) and n.name == "edges_per_step")
    scope = {"L": 2, "T": 3}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "<fn>", "exec"),
         scope)
    return scope["edges_per_step"]


@pytest.mark.parametrize("b", [1, 16, 128, 1024, 4096])
def test_edges_per_step_equals_the_jax_scripts(b):
    assert fb.edges_per_step(b) == _jax_edges_per_step()(b)


def test_the_constants_and_draws_are_the_jax_scripts():
    src = ast.unparse(_jax_main())
    assert "N, FEAT, T, L = (args.tracks, 512, 3, 2)" in src
    assert "init_pinsage(jax.random.PRNGKey(0), L, FEAT, 512, 128)" in src
    assert (fb.FEAT, fb.T, fb.L, fb.HIDDEN, fb.OUT) == (512, 3, 2, 512, 128)
    rng = np.random.default_rng(0)
    n = 50
    want = (rng.normal(size=(n, 512)).astype(np.float32),
            rng.integers(0, n, (n, 100)).astype(np.int32),
            np.sort(rng.random((n, 100)).astype(np.float32),
                    axis=1)[:, ::-1].copy(),
            rng.integers(0, n, (50_000, 2)).astype(np.int32))
    got = fb.bench_data(np.random.default_rng(0), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jax_defaults = {
        call.args[0].value: ast.literal_eval(kw.value)
        for call in ast.walk(_jax_main()) if isinstance(call, ast.Call)
        and getattr(call.func, "attr", "") == "add_argument"
        for kw in call.keywords if kw.arg == "default"}
    assert set(jax_defaults) == {"--tracks", "--batches", "--chunk-small",
                                 "--chunk-large", "--embed-tracks"}
    args = fb.parse_args([])
    for flag, value in jax_defaults.items():
        assert getattr(args, flag[2:].replace("-", "_")) == value
    assert args.skip_embed is False


@pytest.fixture(scope="module")
def jax_keys():
    with open(os.path.join(REPO, "results", "fullgraph_bench.json")) as f:
        return set(json.load(f))


@pytest.mark.parametrize("skip_embed", [True, False])
def test_a_small_run_has_the_scripts_keys(jax_keys, skip_embed, capsys):
    out = fb.main(SMALL + (["--skip-embed"] if skip_embed else []))
    assert json.loads(capsys.readouterr().out.strip()) == out
    # the script's key scheme, for its own batch sizes and for these
    scheme = {"n_tracks"} | {f"B{b}_{s}_{k}" for b in (128, 1024, 4096)
                             for s in ("off", "on")
                             for k in ("ms", "Medges_s")}
    embed = {"embed1m_blocks_s", "embed1m_fullgraph_s"}
    assert jax_keys == scheme | embed
    want = {"n_tracks"} | {f"B{b}_{s}_{k}" for b in (16, 64)
                           for s in ("off", "on")
                           for k in ("ms", "Medges_s")}
    want |= {"auto_picks_winner", "platform"}
    if not skip_embed:
        want |= embed
    assert set(out) == want
    assert out["n_tracks"] == 600 and out["platform"] == "cpu"
    for b in (16, 64):
        on_wins = out[f"B{b}_on_ms"] < out[f"B{b}_off_ms"]
        assert out["auto_picks_winner"][f"B{b}"] == (
            fullgraph_wins(3 * b, 600, 2, 3) == on_wins)
        for s in ("off", "on"):
            assert np.isfinite(out[f"B{b}_{s}_ms"])
            assert out[f"B{b}_{s}_Medges_s"] == round(
                fb.edges_per_step(b) / (out[f"B{b}_{s}_ms"] * 1e-3) / 1e6, 1)


@pytest.mark.parametrize("b", [16, 40])
def test_off_and_on_steps_train_alike(b):
    n = 300
    features, nb_n, nb_w, positives = fb.bench_data(
        np.random.default_rng(0), n)
    tables = TrainTables.build(features, nb_w, nb_n, fb.T)
    positives = torch.as_tensor(positives)
    params = fb.seeded_params(torch.device("cpu"), fb.FEAT)
    cfg = fb.strategy_config(b, "off")
    gen = block_generator(1, 0, torch.device("cpu"))
    batches = [sample_train_batch(gen, positives, tables, cfg.train, n, i)
               for i in range(3)]
    runs = {}
    for strat in ("off", "on"):
        cfg = fb.strategy_config(b, strat)
        p = copy.deepcopy(params)
        opt = make_optimizer(p, cfg.train)
        losses = [float(train_step(p, opt, batch, tables, cfg.train,
                                   cfg.model, strat == "on")[0])
                  for batch in batches]
        runs[strat] = (losses, [x.detach().numpy().copy()
                                for _, x in p.leaves()])
    np.testing.assert_allclose(runs["on"][0], runs["off"][0], **TRAJ)
    assert runs["on"][0][0] == pytest.approx(runs["off"][0][0], rel=1e-5)
    for x, y in zip(runs["on"][1], runs["off"][1]):
        np.testing.assert_allclose(x, y, **TRAJ)
