"""The port's ``scale_demo`` against ``scripts/scale_demo.py``, on the CPU.

The dataset it writes is byte-identical to the one the JAX script's
generator call writes, for each of its three recipes: the hard one (the
streamed JSON writers forced by patching both generators'
``_STREAM_JSON_MIN``), the uniform one and, past ``LARGE_MIN`` tracks
(patched down), the vectorized one.  Its summary carries the JAX
script's keys, its run name equals the JAX script's for every
``--colisten-copies`` / ``--T``, a second run reuses the dataset and
resumes the finished model, and a dataset of the other kind is refused.
"""

import ast
import json
import os

import numpy as np
import pytest

from gcn_song_embeddings_tpu.data import synth as jsynth
from gcn_song_embeddings_tpu_torch import scale_demo
from gcn_song_embeddings_tpu_torch.data import synth as tsynth
from torch_capstone import (
    CAPSTONE,
    TINY,
    assigned_dict,
    dict_keys,
    script_tree,
)
from torch_threads import one_torch_thread  # noqa: F401

DATA_FILES = ("collections.json", "features.npy", "graph.json",
              "positives.json", "tracks.json")


def _same_files(got_dir, want_dir):
    names = sorted(f for f in os.listdir(want_dir))
    assert sorted(f for f in os.listdir(got_dir)
                  if f != "dataset_kind.txt") == names
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(got_dir, name)) as a, \
                    np.load(os.path.join(want_dir, name)) as b:
                assert a.files == b.files
                for key in a.files:
                    np.testing.assert_array_equal(a[key], b[key])
        else:
            with open(os.path.join(got_dir, name), "rb") as a, \
                    open(os.path.join(want_dir, name), "rb") as b:
                assert a.read() == b.read(), name


@pytest.mark.parametrize("kind", ["hard", "uniform", "large"])
def test_dataset_equals_the_jax_scripts_generator_call(tmp_path, monkeypatch,
                                                       kind):
    """The generator calls of scripts/scale_demo.py:94-112 at 2,000
    tracks (each recipe's shape arguments as the script passes them)."""
    argv = ["--tracks", "2000", "--collections", "400", "--clusters", "20",
            "--positives", "3000", "--feature-dim", "16"]
    want = str(tmp_path / "want")
    if kind == "hard":
        monkeypatch.setattr(jsynth, "_STREAM_JSON_MIN", 1)
        monkeypatch.setattr(tsynth, "_STREAM_JSON_MIN", 1)
        argv.append("--hard")
        jsynth.make_hard_dataset(
            want, n_tracks=2000, n_collections=400,
            collection_size_range=(8, 400), collection_size_alpha=2.0,
            n_positives=3000, feature_dim=16, seed=0)
    else:
        make = jsynth.make_synthetic_dataset
        if kind == "large":
            monkeypatch.setattr(scale_demo, "LARGE_MIN", 2000)
            make = jsynth.make_synthetic_dataset_large
        make(want, n_tracks=2000, n_collections=400, n_clusters=20,
             tracks_per_collection=30, n_positives=3000, feature_dim=16,
             seed=0)
    got = str(tmp_path / "got")
    scale_demo.make_dataset(scale_demo.parse_args(argv), got,
                            log=lambda *a: None)
    _same_files(got, want)
    with open(os.path.join(got, "dataset_kind.txt")) as f:
        assert f.read() == ("hard" if kind == "hard" else "uniform")


def _jax_run_name():
    """scripts/scale_demo.py's run_name statements, as a function of
    ``args``."""
    tree = script_tree("scale_demo")
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = [n for n in main.body
            if (isinstance(n, ast.Assign)
                and [t.id for t in n.targets
                     if isinstance(t, ast.Name)] == ["run_name"])
            or (isinstance(n, ast.If) and any(
                isinstance(s, ast.AugAssign) and s.target.id == "run_name"
                for s in n.body))]
    assert len(body) == 3
    fn = ast.FunctionDef(
        name="run_name", args=ast.arguments(
            posonlyargs=[], args=[ast.arg(arg="args")], kwonlyargs=[],
            kw_defaults=[], defaults=[]),
        body=[*body, ast.Return(value=ast.Name(id="run_name",
                                               ctx=ast.Load()))],
        decorator_list=[], type_params=[])
    module = ast.fix_missing_locations(ast.Module(body=[fn],
                                                  type_ignores=[]))
    scope = {}
    exec(compile(module, "scripts/scale_demo.py", "exec"), scope)
    return scope["run_name"]


@pytest.mark.parametrize("flags", [
    [], ["--colisten-copies", "1"], ["--T", "10"],
    ["--colisten-copies", "2", "--T", "10"], ["--T", "3"],
    ["--margin", "1e-05", "--lr", "0.0001", "--colisten-copies", "1",
     "--T", "5"]])
def test_run_name_equals_the_jax_scripts(flags):
    args = scale_demo.parse_args(flags)
    assert scale_demo.run_name(args) == _jax_run_name()(args)
    assert scale_demo.demo_config(args).run_name == scale_demo.run_name(args)


def test_capstone_run_name_is_hybrid_1m_s():
    args = scale_demo.parse_args(CAPSTONE)
    assert scale_demo.run_name(args) == "scale_demo_m0.1_lr0.001_co1_T10"


def test_main_prints_the_jax_summary_and_resumes(tmp_path, capsys):
    work = str(tmp_path / "sd")
    argv = [*CAPSTONE, *TINY, "--work-dir", work, "--device", "cpu"]
    summary = scale_demo.main(argv)
    out = capsys.readouterr()
    assert json.loads(out.out) == summary
    assert set(summary) == dict_keys(assigned_dict(
        script_tree("scale_demo"), "summary"))
    assert set(summary["times_s"]) == {"synth", "load_graph", "precompute",
                                       "train", "embed", "eval",
                                       "features_eval"}
    assert summary["n_tracks"] == 2000 and summary["work_dir"] == work
    assert set(summary["metrics"]) == set(summary["features_metrics"]) == {
        "hit@100", "hit@500", "mrr@1000"}
    assert summary["pinsage_over_features_hit100"] == pytest.approx(
        summary["metrics"]["hit@100"]
        / summary["features_metrics"]["hit@100"], rel=1e-3, abs=2e-3)
    run_dir = os.path.join(work, "runs", "scale_demo_m0.1_lr0.001_co1_T10")
    assert os.path.isfile(os.path.join(run_dir, "state.npz"))
    # the trainer swept the co-listen graph under the name refresh_1m reads
    assert os.path.isfile(os.path.join(work, "ds",
                                       "neighborhoods.colisten1.npz"))
    again = scale_demo.main(argv)
    assert "reusing existing dataset" in capsys.readouterr().err
    assert again["metrics"] == summary["metrics"]
    assert again["n_edges"] == summary["n_edges"]


def test_uniform_summary_has_no_features_row(tmp_path, capsys):
    summary = scale_demo.main(
        ["--tracks", "600", "--collections", "150", "--clusters", "10",
         "--positives", "1500", "--feature-dim", "16", "--epochs", "1",
         "--batches-per-epoch", "3", "--work-dir", str(tmp_path / "u"),
         "--device", "cpu"])
    capsys.readouterr()
    assert "features_metrics" not in summary
    assert "features_eval" not in summary["times_s"]
    # under a second of training the rate is not reported (the JAX rule)
    if summary["times_s"]["train"] <= 1:
        assert summary["train_batches_per_s"] is None


def test_another_kind_is_refused_and_a_partial_dataset_remade(tmp_path):
    ds = str(tmp_path / "ds")
    small = ["--tracks", "1000", "--collections", "100", "--clusters", "10",
             "--positives", "800", "--feature-dim", "8"]
    scale_demo.make_dataset(scale_demo.parse_args(small), ds,
                            log=lambda *a: None)
    with pytest.raises(SystemExit, match="'uniform' dataset"):
        scale_demo.make_dataset(scale_demo.parse_args([*small, "--hard"]),
                                ds, log=lambda *a: None)
    # a dataset without a marker is uniform (the JAX script's rule)
    os.remove(os.path.join(ds, "dataset_kind.txt"))
    with pytest.raises(SystemExit, match="wants 'hard'"):
        scale_demo.make_dataset(scale_demo.parse_args([*small, "--hard"]),
                                ds, log=lambda *a: None)
    # an incomplete one (a crashed generation) is written again
    os.remove(os.path.join(ds, "positives.json"))
    scale_demo.make_dataset(scale_demo.parse_args([*small, "--hard"]), ds,
                            log=lambda *a: None)
    assert all(os.path.isfile(os.path.join(ds, f)) for f in DATA_FILES)
    with open(os.path.join(ds, "dataset_kind.txt")) as f:
        assert f.read() == "hard"
