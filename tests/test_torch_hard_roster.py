"""The port's full-roster module on the hard benchmark, on the CPU.

``gcn_song_embeddings_tpu_torch.hard_roster`` is held to the JAX script
(``scripts/hard_roster.py``, loaded from its path): with each package's
``cli.main`` replaced by a recorder (a stub ``emb.npy`` per trained run,
the two CSVs per eval), both scripts issue the same ``train`` and
``eval`` commands, apart from the port's ``--device``; both suffix the co
runs with ``_x<N>`` for other copies, refuse copies below 1 and reuse a
run whose ``emb.npy`` exists.  The port copies its tables under the work
dir and never under ``results/``.  One run goes through the port's real
CLI, with the run list's schedules and the slow eval rows cut by the
test.
"""

import csv
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest

import gcn_song_embeddings_tpu.cli as j_cli
from gcn_song_embeddings_tpu_torch import cli, hard_roster
from gcn_song_embeddings_tpu_torch.data.synth import ensure_hard_dataset
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TABLES = [os.path.join(REPO, "results", f"hard_roster_{t}.csv")
              for t in ("accuracy", "beyond")]
SIZE = ["--tracks", "2000", "--collections", "400", "--positives", "6000"]
ROWS = 12 + 1 + 5 + 1   # fixed rows, Features, five PinSage rows, Hybrid


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_script_hard_roster", os.path.join(REPO, "scripts",
                                               "hard_roster.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quiet(*_a, **_k):
    pass


@pytest.fixture(scope="module")
def tables_bytes():
    out = []
    for path in JAX_TABLES:
        with open(path, "rb") as f:
            out.append(f.read())
    return out


@pytest.fixture(scope="module")
def shared_ds(tmp_path_factory, tables_bytes) -> str:
    ds = str(tmp_path_factory.mktemp("hard_roster") / "ds")
    return ensure_hard_dataset(ds, n_tracks=2000, n_collections=400,
                               n_positives=6000, seed=0, log=_quiet)


def _work(tmp_path, shared_ds, name) -> str:
    work = str(tmp_path / name)
    shutil.copytree(shared_ds, os.path.join(work, "ds"))
    return work


def _recorder(calls: list):
    """A ``cli.main`` that records its argv, writes a stub ``emb.npy`` for
    ``train`` and the two CSVs for ``eval``."""
    def main(argv):
        argv = list(argv)
        calls.append(argv)
        if argv[0] == "train":
            run = os.path.join(argv[argv.index("--run-dir") + 1],
                               argv[argv.index("--run-name") + 1])
            os.makedirs(run, exist_ok=True)
            np.save(os.path.join(run, "emb.npy"), np.ones((2, 2)))
        else:
            ev = argv[argv.index("--eval-dir") + 1]
            os.makedirs(ev, exist_ok=True)
            for name in ("results_accuracy.csv", "results_beyond.csv"):
                with open(os.path.join(ev, name), "w") as f:
                    f.write(f"model,{name}\n")
    return main


def _run_jax(monkeypatch, work, *flags) -> list:
    calls = []
    monkeypatch.setattr(j_cli, "main", _recorder(calls))
    monkeypatch.setattr(sys, "argv", ["hard_roster.py", "--work-dir", work,
                                      *SIZE, "--out-prefix",
                                      os.path.join(work, "jax_tables"),
                                      *flags])
    _jax_script().main()
    return calls


def _run_port(monkeypatch, work, *flags):
    calls = []
    monkeypatch.setattr(hard_roster.cli, "main", _recorder(calls))
    copied = hard_roster.main(["--work-dir", work, *SIZE, "--device", "cpu",
                               *flags])
    return calls, copied


def _normalized(calls, work, drop_device=False) -> list:
    out = []
    for argv in calls:
        argv = [a.replace(work, "<work>") for a in argv]
        if drop_device:
            i = argv.index("--device")
            assert argv[i + 1] == "cpu"
            argv = argv[:i] + argv[i + 2:]
        out.append(argv)
    return out


@pytest.mark.parametrize("copies", ["1", "3"])
def test_commands_equal_jax(tmp_path, monkeypatch, shared_ds, copies):
    flags = ("--colisten-copies", copies, "--epochs", "7")
    j_work = _work(tmp_path, shared_ds, "jax")
    p_work = _work(tmp_path, shared_ds, "port")
    want = _normalized(_run_jax(monkeypatch, j_work, *flags), j_work)
    got, _ = _run_port(monkeypatch, p_work, *flags)
    assert _normalized(got, p_work, drop_device=True) == want
    assert [a[0] for a in want] == ["train"] * 5 + ["eval"]
    names = [a[a.index("--run-name") + 1] for a in want[:5]]
    suffix = "" if copies == "1" else "_x3"
    assert names == ["pinsage_hard", "pinsage_hard_hn", "pinsage_hard_tuned",
                     f"pinsage_hard_co{suffix}",
                     f"pinsage_hard_co512{suffix}"]
    ev = want[-1]
    assert ev[ev.index("--pinsage-runs") + 1:ev.index("--hybrid-runs")] == (
        names)
    assert ev[ev.index("--hybrid-runs") + 1:] == [
        f"pinsage_hard_co512{suffix}"]
    assert "--k" not in ev     # the CLI's default K=1000


def test_run_list_is_module_data():
    runs = hard_roster.run_list(1)
    assert [r for r, _ in runs] == [r.format(suffix="")
                                    for r, _ in hard_roster.RUNS]
    wide = dict(runs)["pinsage_hard_co512"]
    assert "model.hidden_dim=1024" in wide and "model.out_dim=512" in wide
    assert dict(hard_roster.run_list(3))["pinsage_hard_co_x3"][-1] == (
        "walk.colisten_copies=3")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_copies_below_one_are_refused(tmp_path, monkeypatch, shared_ds,
                                      pkg):
    work = _work(tmp_path, shared_ds, pkg)
    with pytest.raises(SystemExit, match="colisten-copies must be >= 1"):
        if pkg == "jax":
            _run_jax(monkeypatch, work, "--colisten-copies", "0")
        else:
            _run_port(monkeypatch, work, "--colisten-copies", "0")
    assert not os.path.exists(os.path.join(work, "runs"))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_run_with_embeddings_is_reused(tmp_path, monkeypatch, shared_ds,
                                         pkg):
    work = _work(tmp_path, shared_ds, pkg)
    for run in ("pinsage_hard", "pinsage_hard_co"):
        os.makedirs(os.path.join(work, "runs", run))
        np.save(os.path.join(work, "runs", run, "emb.npy"), np.zeros(2))
    calls = (_run_jax(monkeypatch, work) if pkg == "jax"
             else _run_port(monkeypatch, work)[0])
    trained = [a[a.index("--run-name") + 1] for a in calls
               if a[0] == "train"]
    assert trained == ["pinsage_hard_hn", "pinsage_hard_tuned",
                       "pinsage_hard_co512"]
    ev = calls[-1]
    assert "pinsage_hard" in ev and "pinsage_hard_co" in ev


def test_tables_go_under_the_work_dir(tmp_path, monkeypatch, shared_ds,
                                      tables_bytes):
    work = _work(tmp_path, shared_ds, "port")
    _, copied = _run_port(monkeypatch, work)
    assert copied == {t: os.path.join(work, f"hard_roster_{t}.csv")
                      for t in ("accuracy", "beyond")}
    for path in copied.values():
        assert os.path.isfile(path)
    prefix = str(tmp_path / "elsewhere" / "tab")
    _, copied = _run_port(monkeypatch, work, "--out-prefix", prefix)
    assert copied["accuracy"] == prefix + "_accuracy.csv"
    for path, want in zip(JAX_TABLES, tables_bytes):
        with open(path, "rb") as f:
            assert f.read() == want


def test_end_to_end_through_the_port_cli(tmp_path, monkeypatch, shared_ds,
                                         tables_bytes):
    # the run list's schedules cut to 1 epoch of 3 batches of 16 (200-hop
    # sweeps), the GNN rows to 20 steps and Node2Vec to 1 epoch
    short = ("train.epochs=1", "train.batches_per_epoch=3",
             "train.batch_size=16", "walk.n_hops=200")
    monkeypatch.setattr(hard_roster, "RUNS", tuple(
        (name, tuple(s for s in sets if not s.startswith("train.epochs="))
         + short) for name, sets in hard_roster.RUNS))
    build = cli.eval_models

    def cut(args, graph, device):
        models = build(args, graph, device)
        for name in ("GraphSAGE", "GAT", "GCN"):
            models[name].kwargs["steps"] = 20
        models["Node2Vec"].epochs = 1
        return models

    monkeypatch.setattr(cli, "eval_models", cut)
    work = _work(tmp_path, shared_ds, "e2e")
    copied = hard_roster.main(["--work-dir", work, *SIZE, "--device", "cpu",
                               "--epochs", "1"])
    for run, _ in hard_roster.run_list(1):
        emb = np.load(os.path.join(work, "runs", run, "emb.npy"))
        out = 512 if run.endswith("co512") else 128
        assert emb.shape == (2000, out) and np.isfinite(emb).all(), run
    with open(copied["accuracy"], newline="") as f:
        rows = list(csv.reader(f))
    names = [r[0] for r in rows[1:]]
    assert len(names) == ROWS
    assert "Hybrid:pinsage_hard_co512" in names and "Random" in names
    assert all(np.isfinite(float(x)) for r in rows[1:] for x in r[1:])
    with np.load(os.path.join(work, "baselines", "knn",
                              "PinSage:pinsage_hard.npz")) as z:
        assert z["knn_n"].shape == (2000, 1000)
    for path, want in zip(JAX_TABLES, tables_bytes):
        with open(path, "rb") as f:
            assert f.read() == want
