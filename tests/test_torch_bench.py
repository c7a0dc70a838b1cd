"""The port's ``bench`` against the repository's ``bench.py``, on the CPU.

``bench.py`` imports the JAX package inside its measured functions, so it
is read with ``ast`` (never imported) and its pure functions are run from
the tree with its own constants:

* ``edges_per_step``, ``flopbound_matmul_flops`` and
  ``flopbound_activation_bytes`` equal the script's, and so do the
  shape constants;
* ``build_problem`` draws the script's arrays, in its order;
* the headline and FLOP-bound configurations equal the JAX package's
  ``config_with_overrides`` of the script's own override dicts, field by
  field;
* ``roofline_predict`` with the script's v5e ceiling as the compute time
  equals the script's, at measured and interpolated widths;
* the bound counts the products the step's function needs (the script's
  count, with the Q projection over the N table rows), at one f32 rate;
* a tiny ``--device cpu`` run prints one JSON line with the script's keys
  (less ``compile_s`` / ``compile_cache``, plus ``warmup_s``,
  ``kernel_build``, ``edges_per_step``, the bounds, the bf16 step,
  ``platform`` and ``card``) and leaves ``BENCH_BASELINE.json``'s bytes
  as they were; without a card and ``--device`` the module raises;
* the gather yardstick's CPU path computes its function, and the stream
  rate's CPU stand-in reads every pass; the probes take ``REPS``
  repetitions whatever ``--reps`` says, as the script's do.
"""

import ast
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.config import RunConfig as JRunConfig
from gcn_song_embeddings_tpu.config import (
    config_with_overrides as j_overrides,
)
from gcn_song_embeddings_tpu_torch import bench
from gcn_song_embeddings_tpu_torch.ops import agg
from gcn_song_embeddings_tpu_torch.train.trainer import use_fullgraph
from torch_capstone import REPO
from torch_threads import one_torch_thread  # noqa: F401

TINY = ["--device", "cpu", "--tracks", "300", "--chunk-small", "1",
        "--chunk-large", "2", "--fb-chunk-small", "1", "--fb-chunk-large",
        "2", "--reps", "1"]
PROBE_KEYS = {"flopbound_roofline_ratio", "roofline_pred_ms",
              "hbm_stream_gbps", "gather_mrows_per_s",
              "gather_wide_row_ratio", "gather_bf16_row_ratio"}


@pytest.fixture(scope="module")
def script() -> ast.Module:
    with open(os.path.join(REPO, "bench.py")) as f:
        return ast.parse(f.read())


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _constants(tree: ast.Module) -> dict:
    return {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
            and n.targets[0].id.isupper()
            and isinstance(n.value, ast.Constant)}


def _script_functions(tree: ast.Module, *names: str, **overrides) -> dict:
    """The script's functions ``names`` run in a scope of its constants
    (with ``overrides``) and numpy."""
    scope = {**_constants(tree), **overrides, "np": np}
    body = [_function(tree, n) for n in names]
    exec(compile(ast.Module(body=body, type_ignores=[]), "<bench.py>",
                 "exec"), scope)
    return scope


def test_the_constants_are_the_scripts(script):
    want = _constants(script)
    for name in ("N_TRACKS", "N_COLS", "FEAT_DIM", "BATCH", "N_LAYERS", "T",
                 "HIDDEN", "OUT", "CHUNK_SMALL", "CHUNK_LARGE", "REPS",
                 "FB_BATCH", "FB_LAYERS", "FB_HIDDEN", "FB_OUT",
                 "FB_CHUNK_SMALL", "FB_CHUNK_LARGE", "GATHER_PASSES"):
        assert getattr(bench, name) == want[name], name
    assert not hasattr(bench, "V5E_CEILING_TFLOPS")
    args = bench.parse_args([])
    assert (args.tracks, args.chunk_small, args.chunk_large,
            args.fb_chunk_small, args.fb_chunk_large, args.reps) == (
        want["N_TRACKS"], want["CHUNK_SMALL"], want["CHUNK_LARGE"],
        want["FB_CHUNK_SMALL"], want["FB_CHUNK_LARGE"], want["REPS"])


@pytest.mark.parametrize("b,n_layers,t", [(128, 2, 3), (1, 2, 3),
                                          (4096, 4, 3), (64, 3, 10)])
def test_edges_per_step_equals_the_scripts(script, b, n_layers, t):
    fn = _script_functions(script, "edges_per_step")["edges_per_step"]
    assert bench.edges_per_step(b, n_layers, t) == fn(b, n_layers, t)
    assert bench.edges_per_step(128, 2, 3) == 5760


@pytest.mark.parametrize("n_tracks", [300, 20000])
def test_the_flop_and_byte_counts_equal_the_scripts(script, n_tracks):
    scope = _script_functions(script, "flopbound_matmul_flops",
                              "flopbound_activation_bytes",
                              N_TRACKS=n_tracks)
    assert (bench.flopbound_matmul_flops(n_tracks)
            == scope["flopbound_matmul_flops"](n_tracks))
    assert (bench.flopbound_activation_bytes(n_tracks)
            == scope["flopbound_activation_bytes"]())
    if n_tracks == 20000:
        assert bench.flopbound_matmul_flops(n_tracks) == 646_673_596_416


@pytest.mark.parametrize("n_tracks", [50, 20000])
def test_build_problem_draws_the_scripts_arrays(script, n_tracks):
    want = _script_functions(script, "build_problem",
                             N_TRACKS=n_tracks)["build_problem"]()
    got = bench.build_problem(0, n_tracks)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _script_overrides(script, function: str, **names) -> tuple[str, dict]:
    """(run_name, overrides) of the script's ``config_with_overrides``
    call in ``function``, evaluated with its constants and ``names``."""
    call = next(n for n in ast.walk(_function(script, function))
                if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "config_with_overrides")
    scope = {**_constants(script), **names}
    run_name = eval(compile(ast.Expression(call.args[0].keywords[0].value),
                            "<name>", "eval"), scope)
    overrides = eval(compile(ast.Expression(call.args[1]), "<overrides>",
                             "eval"), scope)
    return run_name, overrides


@pytest.mark.parametrize("step", ["headline", "float32", "bfloat16"])
def test_the_step_configs_equal_the_jax_packages(script, step):
    if step == "headline":
        name, overrides = _script_overrides(script, "measure_tpu")
        got = bench.headline_config()
    else:
        name, overrides = _script_overrides(script, "measure_flopbound",
                                            dtype=step)
        got = bench.flopbound_config(step)
    want = j_overrides(JRunConfig(run_name=name), overrides)
    assert got.run_name == want.run_name == name
    mine, theirs = dataclasses.asdict(got), dataclasses.asdict(want)
    assert set(mine) == set(theirs)
    for field in mine:
        assert mine[field] == theirs[field], field
    # the headline takes the frontier forward (K3), the FLOP-bound step
    # the full graph (K2)
    assert use_fullgraph(got.train, got.model, bench.N_TRACKS) == (
        step != "headline")


@pytest.mark.parametrize("rates", [
    {256: 135.2e6, 512: 94.6e6, 1024: 48.5e6},
    {256: 2.0e9, 1024: 0.5e9},
    {512: 1.0e9, 1024: 0.6e9}])
def test_roofline_predict_equals_the_scripts_at_its_ceiling(script, rates):
    scope = _script_functions(script, "flopbound_matmul_flops",
                              "flopbound_activation_bytes",
                              "roofline_predict")
    ceiling_s = (bench.flopbound_matmul_flops(bench.N_TRACKS)
                 / (scope["V5E_CEILING_TFLOPS"] * 1e12))
    got = bench.roofline_predict(rates, 748.1e9, ceiling_s)
    want = scope["roofline_predict"](rates, 748.1e9)
    np.testing.assert_allclose(got, want, rtol=1e-15)


def test_the_bound_counts_the_products_the_step_needs():
    p = bench.flopbound_products()
    n, h, o, t = bench.N_TRACKS, bench.FB_HIDDEN, bench.FB_OUT, bench.T
    dims = [bench.FEAT_DIM] + [o] * (bench.FB_LAYERS - 1)
    q_rows = sum(2 * n * t * d * h for d in dims)
    w = sum(2 * n * (d + h) * o for d in dims)
    head = 2 * (3 * bench.FB_BATCH) * o * o * 2
    # the full-graph layer projects each table row once where the script
    # counts N*T rows
    assert p["q_forward"] * t == q_rows
    # the backward forms dWq, and dh after the first layer (whose table,
    # the features, takes no gradient); nothing is recomputed
    assert p["q_backward"] == p["q_forward"] + sum(
        2 * n * d * h for d in dims[1:])
    # W and head: forward + two products of the backward, less the
    # features' gradient in the first layer
    assert p["w"] + 2 * n * bench.FEAT_DIM * o == 3 * w
    assert p["head"] == 3 * head
    # f32 products at one rate, whatever unit runs them: three TF32
    # passes; the bf16 step's forward projections at the bf16 rate
    assert bench.F32_PRODUCT_FLOPS == bench.H100_TF32_FLOPS / 3
    rest = (p["q_backward"] + p["w"] + p["head"]) / bench.F32_PRODUCT_FLOPS
    assert bench.flopbound_bound_ms("float32") == pytest.approx(1e3 * (
        p["q_forward"] / bench.F32_PRODUCT_FLOPS + rest), rel=1e-12)
    assert bench.flopbound_bound_ms("bfloat16") == pytest.approx(1e3 * (
        p["q_forward"] / bench.H100_BF16_FLOPS + rest), rel=1e-12)
    assert 1.5 < bench.flopbound_bound_ms("bfloat16") < (
        bench.flopbound_bound_ms("float32")) < 1.9


def _expected_keys(script, probes: bool, fresh: bool) -> set:
    main = _function(script, "main")
    dumps = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", "") == "dumps")
    keys = {k.value for k in dumps.args[0].keys}
    keys -= {"compile_s", "compile_cache"}
    keys |= {"warmup_s", "kernel_build", "edges_per_step",
             "flopbound_bound_ms", "flopbound_bf16_tflops",
             "flopbound_bf16_mfu_vs_ceiling", "flopbound_bf16_bound_ms",
             "flopbound_bf16_step_ms", "platform", "card"}
    if not probes:
        keys -= PROBE_KEYS
    if fresh:
        keys.add("vs_baseline_this_host")
    return keys


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("extra", [[], ["--skip-probes",
                                        "--fresh-baseline"]])
def test_a_tiny_cpu_run_prints_the_full_key_set(script, capsys, extra,
                                                monkeypatch):
    monkeypatch.setattr(bench, "STREAM_MIB", 1)
    before = _digest(bench.BASELINE_PATH)
    out = bench.main(TINY + extra)
    assert _digest(bench.BASELINE_PATH) == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == _expected_keys(script, not extra, bool(extra))
    assert out["metric"] == "train_edges_per_s_chip"
    assert out["edges_per_step"] == 5760
    assert out["platform"] == "cpu" and out["card"] is None
    assert out["kernel_build"] == "none"
    # the cached baseline is for 20,000 tracks, not this run's 300
    assert out["vs_baseline"] is None
    assert out["value"] == pytest.approx(
        5760 / (out["warm_step_ms"] * 1e-3), rel=1e-4)
    for prefix, dtype in (("flopbound", "float32"),
                          ("flopbound_bf16", "bfloat16")):
        assert out[f"{prefix}_bound_ms"] == round(
            bench.flopbound_bound_ms(dtype, 300), 3)
        assert out[f"{prefix}_tflops"] > 0
    assert out["flopbound_contig_step_ms"] > 0
    if not extra:
        assert set(out["gather_mrows_per_s"]) == {"256", "512", "1024"}
        assert out["roofline_pred_ms"]["matmul"] == round(
            bench.flopbound_bound_ms("float32", 300), 3)
    else:
        assert out["vs_baseline_this_host"] > 0


def test_the_probes_take_the_scripts_reps_whatever_reps_says(monkeypatch):
    """``bench.py``'s probes take the median of its REPS rep differences
    whatever its chunks take; ``--reps 1`` cuts the chunks only."""
    monkeypatch.setattr(bench, "STREAM_MIB", 1)
    monkeypatch.setattr(bench, "measure_step",
                        lambda *a, **k: (1e-3, 0.0, "none"))
    monkeypatch.setattr(bench, "measure_flopbound",
                        lambda *a, **k: (1e-2, 1.0))
    reps = []

    def rep_difference(wall, run, small, large, n_reps):
        reps.append(n_reps)
        return 1e-3

    monkeypatch.setattr(bench, "rep_difference", rep_difference)
    bench.run(bench.parse_args(TINY))
    # three f32 gather widths, the bf16 gather and the stream
    assert reps == [bench.REPS] * 5


def test_the_cached_baseline_is_read_for_the_benchs_config():
    with open(bench.BASELINE_PATH) as f:
        want = json.load(f)["torch_cpu_s_per_batch"]
    assert bench.cached_baseline(bench.N_TRACKS) == want
    assert bench.cached_baseline(300) is None


def test_without_a_card_or_device_the_module_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(TINY[2:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_gather_probe_sums_the_gathered_rows_on_the_cpu(dtype):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, 40).astype(np.int32)
    t = torch.as_tensor(table).to(dtype)
    got = agg.gather_read_probe(t, torch.as_tensor(idx), 3)
    rows = t.float().numpy().astype(np.float64)
    want = sum(rows[(idx.astype(np.int64) + r) % 50].sum() for r in range(3))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-4)
    assert float(got) == float(agg.gather_read_probe_plain(
        t, torch.as_tensor(idx), 3))


def test_the_stream_rate_reads_every_pass_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bench, "STREAM_MIB", 1)
    passes = []
    real_sum = torch.Tensor.sum

    def counted_sum(self, *a, **k):
        passes.append(self.numel())
        return real_sum(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "sum", counted_sum)
    bw = bench.measure_stream_bw(torch.device("cpu"), reps_small=1,
                                 reps_large=3, reps=2)
    # one read of the whole array a pass: the two warm-up calls, then
    # two pairs of (3, 1) passes
    assert passes == [1024 * 1024 // 4] * (1 + 3 + 2 * (3 + 1))
    assert bw > 0


@pytest.mark.parametrize("call,match", [
    (lambda: agg.gather_read_probe(torch.zeros(4, 4, dtype=torch.float16),
                                   torch.zeros(2, dtype=torch.int32), 1),
     "f32 or bf16"),
    (lambda: agg.gather_read_probe(torch.zeros(4, 4),
                                   torch.zeros(2, dtype=torch.int64), 1),
     "idx must be"),
    (lambda: agg.gather_read_probe(torch.zeros(4, 4),
                                   torch.zeros(2, dtype=torch.int32), 0),
     "reps be >= 1")])
def test_the_gather_probe_refuses_what_it_does_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()
