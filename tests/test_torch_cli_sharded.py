"""The port's sharded CLI verbs as a user runs them: under ``torchrun``
with two ranks on the CPU (gloo), each held against the single-process
verb.

  * ``all --mesh-graph 2``: rank 0 prepares and evaluates, both ranks
    train; its checkpoint embeds through ``cli embed`` in one process to
    the ``emb.npy`` rank 0 wrote.
  * ``train --mesh-graph 2`` on the same run: both ranks resume the
    ``state.npz`` of ``all`` and train the second epoch only.
  * ``serve --sharded`` (f32, ``--int8``, ``--hybrid --cached-head``):
    one HTTP request through rank 0, equal up to ties to the
    single-process index ``serve`` builds for the same flags.
  * ``train --mesh-graph 2`` SIGKILLed mid-run, ranks included (torchrun
    starts each rank in a session of its own, so they are killed by
    pid), after 0, 1 and 3 chunk lines, then run to its end: it resumes
    the last checkpoint and ends with the parameters, Adam state and
    embeddings of an uninterrupted run, bit for bit (the CPU repeats the
    same ops in the same order; each chunk draws from a generator keyed
    by its first global batch).  The mirror of
    ``tests/test_fault_tolerance.py`` for the sharded trainer.
"""

import json
import os
import re
import shutil
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch import serve as ts
from torch_dist import (
    _children,
    same_up_to_ties,
    stop,
    torchrun,
    torchrun_to_end,
)
from torch_threads import one_torch_thread  # noqa: F401

N_TRACKS, K, QUERY = 150, 10, [0, 5, 77, 149]
TRAIN = ["--set", "train.batches_per_epoch=3", "--set", "train.batch_size=8",
         "--set", "walk.n_hops=50", "--set", "model.hidden_dim=32",
         "--set", "model.out_dim=16", "--device", "cpu"]
SERVES = {"f32": [], "int8": ["--int8"],
          "hybrid": ["--hybrid", "--cached-head"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``all`` then ``train`` under torchrun; the checkpoint, config and
    embeddings ``all`` left are copied aside before ``train`` resumes."""
    d = tmp_path_factory.mktemp("cli_sharded")
    ds, runs_dir, ev = str(d / "ds"), str(d / "runs"), str(d / "eval")
    cli.main(["synth", "--dataset", ds, "--n-tracks", str(N_TRACKS),
              "--n-collections", "40", "--n-positives", "500",
              "--feature-dim", "16", "--seed", "2"])
    run = os.path.join(runs_dir, "m")
    common = ["--dataset", ds, "--run-dir", runs_dir, "--run-name", "m",
              "--mesh-graph", "2", *TRAIN]
    out = {"ds": ds, "run": run, "ev": ev, "after_all": str(d / "after_all")}
    out["all_log"] = torchrun_to_end(
        2, "gcn_song_embeddings_tpu_torch.cli",
        ["all", *common, "--set", "train.epochs=1", "--k", "20",
         "--models", "Random", "PinSage:m", "--eval-dir", ev],
        str(d / "all.log"))
    shutil.copytree(run, out["after_all"])
    out["train_log"] = torchrun_to_end(
        2, "gcn_song_embeddings_tpu_torch.cli",
        ["train", *common, "--set", "train.epochs=2"], str(d / "train.log"))
    return out


def _embed(ckpt_dir, ds, out):
    cli.main(["embed", "--dataset", ds, "--out", out, "--checkpoint",
              os.path.join(ckpt_dir, "state.npz"), "--device", "cpu"])
    return np.load(out)


def test_all_mesh_graph_under_torchrun(runs, tmp_path):
    with open(os.path.join(runs["ev"], "results_accuracy.csv")) as f:
        rows = {line.split(",")[0] for line in f.read().splitlines()}
    assert {"Random", "PinSage:m"} <= rows
    emb = np.load(os.path.join(runs["after_all"], "emb.npy"))
    assert emb.shape == (N_TRACKS, 16) and np.isfinite(emb).all()
    np.testing.assert_allclose(
        _embed(runs["after_all"], runs["ds"], str(tmp_path / "e.npy")), emb,
        atol=1e-5)
    assert "epoch 1/1" in runs["all_log"]


def test_train_mesh_graph_resumes_under_torchrun(runs, tmp_path):
    """The second run starts from the first's state: it logs epoch 2 and
    not epoch 1, and its Adam count is two epochs' batches."""
    log = runs["train_log"]
    assert "epoch 2/2" in log and "epoch 1/2" not in log
    with np.load(os.path.join(runs["run"], "state.npz")) as z:
        assert int(z["adam.count"]) == 6
    emb = np.load(os.path.join(runs["run"], "emb.npy"))
    assert not np.allclose(
        emb, np.load(os.path.join(runs["after_all"], "emb.npy")))
    np.testing.assert_allclose(
        _embed(runs["run"], runs["ds"], str(tmp_path / "e.npy")), emb,
        atol=1e-5)


def _bound_port(log: str) -> int | None:
    """The port a server started with ``--port 0`` reports once it has
    bound it, else None."""
    with open(log) as f:
        m = re.search(r"serving \d+ tracks on :(\d+)", f.read())
    return int(m.group(1)) if m else None


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def served(runs, tmp_path_factory):
    """The three ``serve --sharded`` forms started together, each on a
    port it binds itself (``--port 0``, read back from its log: a port
    picked here and released would be free for any other process to take
    until the server bound it), asked one batched request once it answers
    /healthz, then stopped."""
    d = tmp_path_factory.mktemp("serve_sharded")
    emb = os.path.join(runs["run"], "emb.npy")
    procs, out = {}, {}
    try:
        for kind, flags in SERVES.items():
            procs[kind] = torchrun(
                2, "gcn_song_embeddings_tpu_torch.serve",
                ["--sharded", "--emb", emb, "--dataset", runs["ds"],
                 "--port", "0", "--device", "cpu", *flags],
                str(d / f"{kind}.log"))
        deadline = time.monotonic() + 240
        for kind, proc in procs.items():
            log = str(d / f"{kind}.log")
            while kind not in out:
                if proc.poll() is not None or time.monotonic() > deadline:
                    with open(log) as f:
                        raise AssertionError(f"serve --sharded {kind} ended "
                                             f"{proc.poll()}:\n"
                                             f"{f.read()[-6000:]}")
                port = _bound_port(log)
                if port is None:
                    time.sleep(0.2)
                    continue
                try:
                    health = _get(port, "/healthz")
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.2)
                    continue
                rows = ",".join(map(str, QUERY))
                out[kind] = (health, _get(port, f"/knn?indices={rows}&k={K}"))
    finally:
        for proc in procs.values():
            stop(proc)
    return out


def _single(runs, kind):
    """The single-process index ``serve`` builds for the same flags."""
    emb = np.load(os.path.join(runs["run"], "emb.npy"))
    if kind == "hybrid":
        graph, _, nbhds = ts.cached_head_artifacts(runs["ds"], 1, "cpu")
        return ts.HybridIndex(emb, nbhds=nbhds, track_ids=graph.track_ids,
                              device="cpu")
    return ts.EmbeddingIndex(emb, quantized=kind == "int8", device="cpu")


@pytest.mark.parametrize("kind", list(SERVES))
def test_serve_sharded_under_torchrun(runs, served, kind):
    health, body = served[kind]
    assert health["tracks"] == N_TRACKS
    want = _single(runs, kind).knn_rows(np.asarray(QUERY), K)
    assert [len(r) for r in body["neighbors"]] == [K] * len(QUERY)
    assert [len(r) for r in want] == [K] * len(QUERY)
    w, w_ref = ([[o["score"] for o in r] for r in rs]
                for rs in (body["neighbors"], want))
    n, n_ref = ([[o["index"] for o in r] for r in rs]
                for rs in (body["neighbors"], want))
    same_up_to_ties(w, n, w_ref, n_ref)
    assert not (np.asarray(n) == np.asarray(QUERY)[:, None]).any()


# the SIGKILL test: 4 epochs of 20 batches in chunks of 10, each chunk's
# line printed by rank 0 after its checkpoint is written
FT_EPOCHS = 4
FT = ["--set", f"train.epochs={FT_EPOCHS}",
      "--set", "train.batches_per_epoch=20",
      "--set", "train.checkpoint_every_batches=10",
      "--set", "train.batch_size=32", "--set", "walk.n_hops=50",
      "--set", "model.hidden_dim=64", "--set", "model.out_dim=16",
      "--device", "cpu"]
KILL_AFTER_CHUNKS = (0, 1, 3)   # chunk lines a killed run prints first
LINE_TIMEOUT_S = 120


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _wait_for(proc, log, prefix, count):
    """Until ``log`` holds ``count`` lines starting with ``prefix`` (or
    the run ends, or LINE_TIMEOUT_S passes); returns its lines."""
    deadline = time.monotonic() + LINE_TIMEOUT_S
    while time.monotonic() < deadline and proc.poll() is None:
        lines = _lines(log)
        if sum(line.startswith(prefix) for line in lines) >= count:
            return lines
        time.sleep(0.01)
    raise AssertionError(f"no {count} {prefix!r} lines: {_lines(log)}")


def _sigkill(proc) -> list:
    """SIGKILL the ranks, then torchrun; returns the ranks as (pid, start
    time) once each has ended or LINE_TIMEOUT_S has passed.  A SIGKILL
    ends a process only once the kernel has torn it down (its threads,
    its memory), which under load can outlast torchrun's own exit, so
    the ranks are waited for, not read the moment torchrun is reaped."""
    ranks = [(pid, _start_time(pid)) for pid in _children(proc.pid)]
    for pid in [pid for pid, _ in ranks] + [proc.pid]:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()
    deadline = time.monotonic() + LINE_TIMEOUT_S
    while (any(_alive(*rank) for rank in ranks)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    return ranks


def test_train_mesh_graph_sigkilled_resumes_to_an_uninterrupted_run(
        tmp_path):
    ds = str(tmp_path / "ds")
    cli.main(["synth", "--dataset", ds, "--n-tracks", str(N_TRACKS),
              "--n-collections", "40", "--n-positives", "500",
              "--feature-dim", "16", "--seed", "2"])
    runs = str(tmp_path / "runs")

    def train(name, log):
        return torchrun(2, "gcn_song_embeddings_tpu_torch.cli",
                        ["train", "--dataset", ds, "--run-dir", runs,
                         "--run-name", name, "--mesh-graph", "2", *FT],
                        str(tmp_path / log))

    state = os.path.join(runs, "ft", "state.npz")
    landed = []
    for i, chunks in enumerate(KILL_AFTER_CHUNKS):
        log = str(tmp_path / f"killed{i}.log")
        proc = train("ft", f"killed{i}.log")
        try:
            if chunks:
                _wait_for(proc, log, "epoch ", chunks)
            else:   # the first run, in its sweep (rank 0's block line)
                _wait_for(proc, log, "neighborhoods[rank 0/2]", 1)
            had_state = os.path.isfile(state)
            ranks = _sigkill(proc)
        finally:
            stop(proc)
        assert proc.returncode == -signal.SIGKILL, _lines(log)
        assert len(ranks) == 2 and not any(_alive(*rank) for rank in ranks)
        landed.append(had_state and not any(
            "embeddings ->" in line for line in _lines(log)))

    last = torchrun_to_end(2, "gcn_song_embeddings_tpu_torch.cli",
                           ["train", "--dataset", ds, "--run-dir", runs,
                            "--run-name", "ft", "--mesh-graph", "2", *FT],
                           str(tmp_path / "last.log"))
    whole = torchrun_to_end(2, "gcn_song_embeddings_tpu_torch.cli",
                            ["train", "--dataset", ds, "--run-dir", runs,
                             "--run-name", "whole", "--mesh-graph", "2",
                             *FT], str(tmp_path / "whole.log"))
    assert any(landed), landed
    # the last run picked the run up where a checkpoint left it
    lines = last.splitlines()
    resumed = [line for line in lines if line.startswith("resumed from")]
    assert resumed and " batch 0)" not in resumed[0], lines
    chunk_lines = [line for line in lines if line.startswith("epoch ")]
    assert chunk_lines and len(chunk_lines) < 2 * FT_EPOCHS
    assert f"epoch {FT_EPOCHS}/{FT_EPOCHS}" in chunk_lines[-1]
    assert "resumed from" not in whole
    assert not os.path.exists(state + ".tmp")
    with np.load(state) as z, np.load(os.path.join(
            runs, "whole", "state.npz")) as w:
        assert float(z["__scalar__epochs_done"]) == FT_EPOCHS
        assert float(z["__scalar__batches_done"]) == 0
        assert sorted(z.files) == sorted(w.files)
        for k in z.files:
            np.testing.assert_array_equal(z[k], w[k], err_msg=k)
    np.testing.assert_array_equal(
        np.load(os.path.join(runs, "ft", "emb.npy")),
        np.load(os.path.join(runs, "whole", "emb.npy")))


def _stat(pid: int) -> list:
    """The fields of ``/proc/<pid>/stat`` after the command name ([] once
    the process is gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()
    except OSError:
        return []


def _start_time(pid: int) -> str:
    """When ``pid`` started (clock ticks after boot), which tells it from
    a later process given the same pid."""
    fields = _stat(pid)
    return fields[19] if fields else ""


def _alive(pid: int, start: str) -> bool:
    """Whether the process ``pid`` that started at ``start`` runs (a
    zombie, killed and not yet reaped by its parent, does not)."""
    fields = _stat(pid)
    return bool(fields) and fields[19] == start and fields[0] != "Z"
