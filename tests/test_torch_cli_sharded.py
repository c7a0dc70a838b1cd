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
"""

import json
import os
import shutil
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch import serve as ts
from torch_dist import same_up_to_ties, stop, torchrun, torchrun_to_end
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def served(runs, tmp_path_factory):
    """The three ``serve --sharded`` forms started together, each asked
    one batched request once it answers /healthz, then stopped."""
    d = tmp_path_factory.mktemp("serve_sharded")
    emb = os.path.join(runs["run"], "emb.npy")
    procs, out = {}, {}
    try:
        for kind, flags in SERVES.items():
            port = _free_port()
            procs[kind] = (port, torchrun(
                2, "gcn_song_embeddings_tpu_torch.serve",
                ["--sharded", "--emb", emb, "--dataset", runs["ds"],
                 "--port", str(port), "--device", "cpu", *flags],
                str(d / f"{kind}.log")))
        deadline = time.monotonic() + 240
        for kind, (port, proc) in procs.items():
            while kind not in out:
                if proc.poll() is not None or time.monotonic() > deadline:
                    with open(d / f"{kind}.log") as f:
                        raise AssertionError(f"serve --sharded {kind} ended "
                                             f"{proc.poll()}:\n"
                                             f"{f.read()[-6000:]}")
                try:
                    health = _get(port, "/healthz")
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.2)
                    continue
                rows = ",".join(map(str, QUERY))
                out[kind] = (health, _get(port, f"/knn?indices={rows}&k={K}"))
    finally:
        for _, proc in procs.values():
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
