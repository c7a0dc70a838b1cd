"""The port's ``grid_refschedule`` against the JAX script, on the CPU.

``gcn_song_embeddings_tpu_torch.grid_refschedule`` is held to
``scripts/grid_refschedule.py`` (read by ``ast``, and its ``main`` run up
to its dataset check):

* each schedule's epochs, batches per epoch, grid and default output file
  name, on both dataset kinds, equal the script's branch for it;
* a complete dataset of another kind (or with no marker, which reads as
  ``uniform``) is refused with the script's message;
* the ``hard`` catalog the module builds is byte for byte the one
  ``ensure_hard_dataset`` and ``hard_bench`` build, so a caller that has
  one (``chip_smoke.py``) reuses it and its PPR caches;
* a ``quick`` run, cut to 1 x 2 batches on a small uniform catalog,
  writes the script's keys for every point of its grid, sorted by MRR,
  into the work dir, and leaves ``results/grid_search*.json`` as they
  were.
"""

import ast
import filecmp
import glob
import json
import os
import types

import pytest

from gcn_song_embeddings_tpu.train.grid_search import (
    get_param_sets as j_param_sets,
)
from gcn_song_embeddings_tpu_torch import grid_refschedule as gr
from gcn_song_embeddings_tpu_torch.data.synth import (
    ensure_hard_dataset,
    make_hard_dataset,
    make_synthetic_dataset,
)
from torch_capstone import REPO, jax_script, script_tree
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ("uniform", "hard")
CUT = {"train.epochs": 1, "train.batches_per_epoch": 2, "walk.n_hops": 50}


def _jax_branches() -> dict:
    """The script's schedule branches in ``main``: {name: statements};
    the chain's last ``else`` is the third choice, ``quick``."""
    main = next(n for n in script_tree("grid_refschedule").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.If)
                and ast.unparse(n.test).startswith("args.schedule =="))
    out = {}
    while True:
        out[node.test.comparators[0].value] = node.body
        if len(node.orelse) == 1 and isinstance(node.orelse[0], ast.If):
            node = node.orelse[0]
            continue
        out["quick"] = node.orelse
        return out


def _jax_schedule(name: str, kind: str):
    """Execute the branch's assignments with ``args.dataset_kind`` set."""
    body = _jax_branches()[name]
    scope = {"args": types.SimpleNamespace(schedule=name, dataset_kind=kind)}
    exec(compile(ast.Module(body=body, type_ignores=[]), "<branch>", "exec"),
         scope)
    return scope["epochs"], scope["bpe"], scope["grid"], scope["default_out"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["ref", "colisten", "quick"])
def test_schedules_equal_the_jax_scripts(name, kind):
    epochs, bpe, grid, default_out = _jax_schedule(name, kind)
    got = gr.schedule(name, kind)
    assert got[:3] == (epochs, bpe, grid)
    assert got[3] == os.path.basename(default_out)
    assert os.path.dirname(default_out) == "results"
    assert j_param_sets(got[2]) == j_param_sets(grid)
    assert set(_jax_branches()) == {"ref", "colisten", "quick"}
    assert gr.parse_args(["--schedule", name,
                          "--dataset-kind", kind]).schedule == name


def _fake_dataset(ds: str, marker: str | None) -> None:
    """The three files the script's completeness check looks for."""
    os.makedirs(ds, exist_ok=True)
    for f in gr.DATASET_FILES:
        open(os.path.join(ds, f), "w").close()
    if marker is not None:
        with open(os.path.join(ds, "dataset_kind.txt"), "w") as f:
            f.write(marker)


@pytest.mark.parametrize("marker,kind", [("uniform", "hard"),
                                         (None, "hard"),
                                         ("hard", "uniform")])
def test_a_dataset_of_another_kind_is_refused_as_by_the_jax_script(
        tmp_path, monkeypatch, marker, kind):
    work = str(tmp_path)
    _fake_dataset(os.path.join(work, "ds"), marker)
    argv = ["--schedule", "quick", "--dataset-kind", kind,
            "--work-dir", work]
    monkeypatch.setattr("sys.argv", ["grid_refschedule.py", *argv])
    with pytest.raises(SystemExit) as jax_exit:
        jax_script("grid_refschedule").main()
    with pytest.raises(SystemExit) as port_exit:
        gr.main([*argv, "--device", "cpu"])
    assert str(port_exit.value) == str(jax_exit.value)
    assert "refusing to mislabel results" in str(port_exit.value)


def test_the_hard_catalog_is_the_hard_benchmarks(tmp_path):
    grid_ds = str(tmp_path / "grid")
    gr.ensure_dataset(grid_ds, "hard")
    ensure_hard_dataset(str(tmp_path / "ab"), log=lambda *a: None)
    make_hard_dataset(str(tmp_path / "bench"), feature_dim=128, seed=0)
    names = sorted(os.listdir(grid_ds))
    assert "dataset_kind.txt" in names and set(gr.DATASET_FILES) <= set(
        names)
    for other in ("ab", "bench"):
        files = [f for f in names if f != "dataset_kind.txt"]
        match, mismatch, errors = filecmp.cmpfiles(
            grid_ds, str(tmp_path / other), files, shallow=False)
        assert (mismatch, errors) == ([], []), other
    with open(os.path.join(grid_ds, "dataset_kind.txt")) as f:
        assert f.read() == "hard"


@pytest.fixture(scope="module")
def results_bytes():
    out = {}
    for path in glob.glob(os.path.join(REPO, "results", "grid_search*.json")):
        with open(path, "rb") as f:
            out[path] = f.read()
    assert out
    return out


def test_a_quick_run_writes_the_scripts_keys_sorted_by_mrr(
        tmp_path, results_bytes):
    work = str(tmp_path)
    ds = os.path.join(work, "ds")
    make_synthetic_dataset(ds, n_tracks=400, n_collections=80,
                           n_clusters=8, n_positives=1200, feature_dim=16,
                           seed=0)
    with open(os.path.join(ds, "dataset_kind.txt"), "w") as f:
        f.write("uniform")
    args = gr.parse_args(["--schedule", "quick", "--work-dir", work,
                          "--device", "cpu"])
    results = gr.run(args, log=lambda *a: None, base_overrides=CUT)
    with open(os.path.join(work, "grid_search1.json")) as f:
        written = json.load(f)
    assert written == results
    with open(os.path.join(REPO, "results", "grid_search1.json")) as f:
        jax_rows = json.load(f)
    assert [set(r) for r in written] == [set(jax_rows[0])] * len(jax_rows)
    mrr = [r["mrr"] for r in written]
    assert mrr == sorted(mrr, reverse=True)
    _, _, grid, _ = gr.schedule("quick", "uniform")
    assert sorted((r["id"], r["params"]) for r in written) == sorted(
        j_param_sets(grid))
    assert sorted(r["id"] for r in jax_rows) == sorted(
        r["id"] for r in written)
    for r in written:
        assert 0.0 < r["mrr"] <= 1.0 and 0.0 <= r["hit_rate"] <= 1.0
    assert len(os.listdir(os.path.join(work, "runs_gs"))) == len(written)
    for path, data in results_bytes.items():
        with open(path, "rb") as f:
            assert f.read() == data, path
