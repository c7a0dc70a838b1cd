"""Fault tolerance of the port's trainer: SIGKILL mid-training must leave
a resumable state.

Mirror of ``tests/test_fault_tolerance.py`` for the port's
``PinSageTrainer`` on the CPU (checkpoints are one ``.npz`` written to a
tmp file and renamed, ``utils/checkpoint.py``).  The port starts far
faster than JAX compiles, so sleeps sized for JAX would kill after the
run has finished: the kills are placed on observed progress instead.
Each killed run is started, its ``START`` line awaited, then killed
after a staggered number of its own chunk lines (each printed after that
chunk's checkpoint is written); later runs go to the end.  A fresh
trainer must always resume and complete, with no tmp file left and the
metrics rows in whole chunks; at least one kill must land after a
``state.npz`` existed and before ``DONE``.

The trainer also reloads the PPR neighborhood cache when it resumes, so
that artifact is written atomically too: a write that fails part way
leaves the previous artifact whole.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from gcn_song_embeddings_tpu_torch.config import WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.ops.ppr import precompute_neighborhoods
from gcn_song_embeddings_tpu_torch.utils.checkpoint import atomic_savez

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, BATCHES, CHUNK = 4, 8, 2
KILL_AFTER_CHUNKS = (0, 1, 3)   # chunk lines a killed run prints first
LINE_TIMEOUT_S = 120            # a run's start, or one chunk, at most
RUN_TIMEOUT_S = 300

TRAIN_SNIPPET = """
import sys
sys.modules["jax"] = None
sys.modules["gcn_song_embeddings_tpu"] = None
import torch
torch.set_num_threads(1)
from gcn_song_embeddings_tpu_torch.config import (
    RunConfig, config_with_overrides)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer

ds, run_dir = sys.argv[1], sys.argv[2]
g = SongGraph(ds, features_file=ds + "/features.npy")
pos = g.load_positives(ds + "/positives.json")
cfg = config_with_overrides(RunConfig(run_name="ft"), {
    "train.epochs": %d, "train.batches_per_epoch": %d,
    "train.batch_size": 16, "train.checkpoint_every_batches": %d,
    "walk.n_hops": 50, "walk.batch_walkers": 256})
tr = PinSageTrainer(DeviceGraph.from_graph(g, "cpu"), g.n_items, g.features,
                    pos, cfg=cfg, base_run_dir=run_dir,
                    nbhds_path=ds + "/nb_ft.npz", log=True,
                    load_save=True, verbose=True)
print("START", tr.e, tr.b, flush=True)
tr.train()
print("DONE", tr.e, flush=True)
""" % (EPOCHS, BATCHES, CHUNK)


class Run:
    """The training subprocess, its stdout lines read by a thread into a
    queue so every wait has a timeout."""

    def __init__(self, dataset_dir: str, run_dir: str):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-c", TRAIN_SNIPPET, dataset_dir,
             run_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.seen: list[str] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))
        self.lines.put(None)

    def wait_for(self, prefix: str) -> str:
        """The next line starting with ``prefix``; fails at the run's end
        or after LINE_TIMEOUT_S without one."""
        while True:
            line = self.lines.get(timeout=LINE_TIMEOUT_S)
            if line is None:
                raise AssertionError(f"run ended before {prefix!r}: "
                                     f"{self.seen}")
            self.seen.append(line)
            if line.startswith(prefix):
                return line

    def finish(self) -> str:
        """Wait for the run's end; all it printed."""
        self.proc.wait(timeout=RUN_TIMEOUT_S)
        self._reader.join(timeout=RUN_TIMEOUT_S)
        assert not self._reader.is_alive()
        while True:
            line = self.lines.get_nowait()
            if line is None:
                return "\n".join(self.seen)
            self.seen.append(line)

    def kill(self) -> str:
        self.proc.send_signal(signal.SIGKILL)
        return self.finish()


def test_sigkill_resume(dataset_dir, tmp_path):
    run_dir = str(tmp_path / "runs")
    state = os.path.join(run_dir, "ft", "state.npz")
    landed, starts = [], []
    for chunks in KILL_AFTER_CHUNKS:
        run = Run(dataset_dir, run_dir)
        starts.append(run.wait_for("START"))
        for _ in range(chunks):
            run.wait_for("epoch ")
        had_state = os.path.isfile(state)
        out = run.kill()
        assert run.proc.returncode == -signal.SIGKILL, out
        landed.append(had_state and "DONE" not in out)

    for _ in range(3):
        run = Run(dataset_dir, run_dir)
        starts.append(run.wait_for("START"))
        out = run.finish()
        assert run.proc.returncode == 0, out
        if f"DONE {EPOCHS}" in out:
            break
    else:
        raise AssertionError("training never completed")

    assert any(landed), (landed, starts)
    # a fresh trainer picked the run up where a checkpoint left it
    assert starts[-1] != "START 0 0", starts
    # state resumable + final epoch recorded
    assert os.path.isfile(state)
    with np.load(state) as z:
        assert float(z["__scalar__epochs_done"]) == EPOCHS
    # no leftover corrupt tmp file
    assert not os.path.isfile(state + ".tmp")
    # metrics rows only ever appended in whole chunks
    with open(os.path.join(run_dir, "ft", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) % CHUNK == 0
    assert len(rows) >= EPOCHS * BATCHES


def test_a_cache_write_cut_short_leaves_the_artifact_whole(
        dataset_dir, tmp_path, monkeypatch):
    g = SongGraph(dataset_dir,
                  features_file=os.path.join(dataset_dir, "features.npy"))
    dg = DeviceGraph.from_graph(g, "cpu")
    path = str(tmp_path / "nbhds.npz")
    cfg = WalkConfig(n_hops=50, batch_walkers=256)
    w, n = precompute_neighborhoods(dg, cfg, path)

    def cut_short(file, **arrays):
        """The first bytes of an archive (to a file name or an open
        file), then the writer's end."""
        if isinstance(file, str):
            with open(file, "wb") as f:
                f.write(b"PK\x03\x04")
        else:
            file.write(b"PK\x03\x04")
        raise OSError("killed mid-write")

    monkeypatch.setattr(np, "savez_compressed", cut_short)
    with pytest.raises(OSError, match="killed mid-write"):
        # another alpha misses the cache: a fresh sweep, then its write
        precompute_neighborhoods(dg, WalkConfig(n_hops=50, alpha=0.5,
                                                batch_walkers=256), path)
    monkeypatch.undo()
    assert not os.path.exists(path + ".tmp")
    with np.load(path) as z:
        np.testing.assert_array_equal(z["weights"], w)
        np.testing.assert_array_equal(z["nodes"], n)
    # the first sweep's artifact is served again, not recomputed
    w2, n2 = precompute_neighborhoods(dg, cfg, path)
    np.testing.assert_array_equal(w2, w)
    np.testing.assert_array_equal(n2, n)


@pytest.mark.parametrize("compressed", [False, True])
def test_atomic_savez_replaces_whole_or_keeps_the_old_file(
        tmp_path, monkeypatch, compressed):
    path = str(tmp_path / "sub" / "a.npz")
    old = np.arange(6, dtype=np.float32).reshape(2, 3)
    atomic_savez(path, compressed=compressed, x=old)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["x"], old)

    def cut_short(file, **arrays):
        file.write(b"PK\x03\x04")
        raise OSError("killed mid-write")

    name = "savez_compressed" if compressed else "savez"
    monkeypatch.setattr(np, name, cut_short)
    with pytest.raises(OSError, match="killed mid-write"):
        atomic_savez(path, compressed=compressed, x=old + 1)
    monkeypatch.undo()
    assert os.listdir(tmp_path / "sub") == ["a.npz"]
    with np.load(path) as z:
        np.testing.assert_array_equal(z["x"], old)
    atomic_savez(path, compressed=compressed, x=old + 1)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["x"], old + 1)
