"""The port's ``prepare`` and ``all`` verbs, the per-track embedding export
and the ``serve`` verb vs the JAX package, on the CPU.

``cli prepare --features random`` writes a ``features_random.npy`` bit-equal
to the JAX CLI's (the same numpy draws in the same batches); with a weights
``.npz`` written by JAX's ``save_weights``, ``--features vggish`` gives
features within rtol 1e-3 / atol 1e-3 of the JAX CLI's on the same clips.
The walk positives are ``generate_walk_positives`` on the neighborhoods
the verb swept (the sweep itself is the port's, from torch draws, so its
pairs differ from JAX's by design).  ``all`` runs prepare -> train -> eval
and writes a ``PinSage:<run>`` row.  The per-track export writes the JAX
trainer's files byte for byte on the same embeddings.
"""

import json
import os
import shutil
import wave

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu import cli as jcli
from gcn_song_embeddings_tpu.models import audio_embedders as J
from gcn_song_embeddings_tpu.train.trainer import (
    PinSageTrainer as JaxTrainer,
)
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.data.positives import (
    generate_walk_positives,
)
from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer
from torch_threads import one_torch_thread  # noqa: F401


def _copy_dataset(src, dst):
    os.makedirs(dst)
    for name in ("graph.json", "tracks.json", "collections.json"):
        shutil.copy(os.path.join(src, name), dst)
    return str(dst)


def test_cli_prepare_random_equals_the_jax_cli(dataset_dir, tmp_path):
    port_ds = _copy_dataset(dataset_dir, tmp_path / "port")
    jax_ds = _copy_dataset(dataset_dir, tmp_path / "jax")
    walls = cli.main(["prepare", "--dataset", port_ds, "--gen-positives",
                      "--seed", "3", "--device", "cpu"])
    assert set(walls) == {"features_s", "sweep_s", "positives_s"}
    jcli.main(["prepare", "--dataset", jax_ds, "--seed", "3"])
    got = np.load(os.path.join(port_ds, "features_random.npy"))
    want = np.load(os.path.join(jax_ds, "features_random.npy"))
    assert got.shape == (500, 512)
    np.testing.assert_array_equal(got, want)

    with np.load(os.path.join(port_ds, "neighborhoods.npz")) as z:
        weights, nodes = z["weights"], z["nodes"]
    with open(os.path.join(port_ds, "tracks.json")) as f:
        ids = list(json.load(f))
    row = {t: i for i, t in enumerate(ids)}
    with open(os.path.join(port_ds, "positives.json")) as f:
        pairs = json.load(f)
    assert pairs == [{"a": ids[p["a"]], "b": ids[p["b"]]} for p in
                     generate_walk_positives((weights, nodes), 500, seed=3)]
    assert 0 < len(pairs) <= 5 * 500
    for p in pairs:
        a, b = row[p["a"]], row[p["b"]]
        assert ((nodes[a, :3] == b) & (weights[a, :3] > 0)).any()


def _write_clips(ds, n, seconds=2.0):
    os.makedirs(os.path.join(ds, "clips"))
    tracks = {f"t{i}": {"name": f"s{i}", "artist": "a"} for i in range(n)}
    with open(os.path.join(ds, "tracks.json"), "w") as f:
        json.dump(tracks, f)
    rng = np.random.default_rng(11)
    for i in range(n):
        sr = 22_050 if i % 2 == 0 else 16_000
        t = np.arange(int(seconds * sr)) / sr
        y = (0.4 * np.sin(2 * np.pi * 300 * (i + 1) * t)
             + 1e-3 * rng.normal(size=t.shape)).astype(np.float32)
        if i % 2:
            np.save(os.path.join(ds, "clips", f"t{i}.npy"), y)
            continue
        with wave.open(os.path.join(ds, "clips", f"t{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((y * 32767).astype(np.int16).tobytes())


def test_cli_prepare_vggish_with_jax_weights(tmp_path):
    weights = str(tmp_path / "vggish.npz")
    J.save_weights(J.init_vggish(seed=0), weights)
    out = {}
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        ds = str(tmp_path / tag)
        _write_clips(ds, 3)
        extra = ["--device", "cpu"] if tag == "port" else []
        main(["prepare", "--dataset", ds, "--features", "vggish2",
              "--feature-weights", weights, *extra])
        out[tag] = np.load(os.path.join(ds, "features_vggish.npy"))
        assert len(os.listdir(os.path.join(ds, "features_vggish"))) == 3
    assert out["port"].shape == (3, 128)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-3,
                               atol=1e-3)


def test_cli_all_writes_a_pinsage_row(dataset_dir, tmp_path):
    ds = _copy_dataset(dataset_dir, tmp_path / "ds")
    runs, ev = str(tmp_path / "runs"), str(tmp_path / "eval")
    args = ["--dataset", ds, "--gen-positives", "--device", "cpu"]
    cli.main(["prepare", *args])
    cache = os.path.join(ds, "neighborhoods.npz")
    stamp = os.stat(cache).st_mtime_ns
    walls = cli.main([
        "all", *args, "--run-dir", runs, "--run-name", "r",
        "--set", "train.epochs=1", "--set", "train.batches_per_epoch=3",
        "--set", "train.batch_size=16", "--k", "20",
        "--models", "Random", "PageRank", "PinSage:r", "--eval-dir", ev])
    assert set(walls) >= {"prepare", "train_s", "eval_s"}
    # all's prepare and train reused the sweep prepare wrote
    assert os.stat(cache).st_mtime_ns == stamp
    emb = np.load(os.path.join(runs, "r", "emb.npy"))
    assert emb.shape == (500, 128) and np.isfinite(emb).all()
    with open(os.path.join(ev, "results_accuracy.csv")) as f:
        rows = {line.split(",")[0]: line for line in f.read().splitlines()}
    assert set(rows) >= {"Random", "PageRank", "PinSage:r"}
    assert os.path.isfile(os.path.join(ev, "results_beyond.csv"))


def test_mesh_graph_refused_before_any_work(tmp_path):
    """A (dp, 2) mesh does not fit a world of one: both verbs refuse it
    before touching the dataset, and leave no process group behind."""
    import torch.distributed as dist

    for verb in ("train", "all"):
        with pytest.raises(ValueError, match="mesh 0x2 != 1 ranks"):
            cli.main([verb, "--dataset", str(tmp_path / "none"),
                      "--mesh-graph", "2", "--device", "cpu"])
        assert not dist.is_initialized()
    assert not os.path.exists(tmp_path / "none")


def test_prepare_refuses_an_unknown_feature_model(tmp_path):
    with pytest.raises(SystemExit, match="unknown feature model"):
        cli.main(["prepare", "--dataset", str(tmp_path), "--features",
                  "wav2vec", "--device", "cpu"])


def test_cli_serve_hands_its_arguments_to_serve(monkeypatch):
    from gcn_song_embeddings_tpu_torch import serve

    seen = []
    monkeypatch.setattr(serve, "main", lambda argv=None: seen.append(argv))
    cli.main(["serve", "--emb", "e.npy", "--int8", "--device", "cpu"])
    assert seen == [["--emb", "e.npy", "--int8", "--device", "cpu"]]


class _Fixed:
    """A trainer stand-in with fixed embeddings (both packages' exports
    read only ``run_dir`` and ``embed()``)."""

    def __init__(self, run_dir, emb):
        self.run_dir, self._emb = run_dir, emb

    def embed(self):
        return self._emb


@pytest.mark.parametrize("fmt", ["npy", "pt"])
def test_save_embeddings_per_track_matches_jax(tmp_path, fmt):
    emb = np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32)
    ids = [f"tr{i}" for i in range(6)]
    keep = np.full(8, 7.0, np.float32)
    dirs = {}
    for tag, cls in (("port", PinSageTrainer), ("jax", JaxTrainer)):
        run = tmp_path / tag
        os.makedirs(run / "emb")
        np.save(run / "emb" / "tr2.npy", keep)      # an existing file
        dirs[tag] = cls.save_embeddings_per_track(_Fixed(str(run), emb), ids,
                                                  fmt=fmt)
        assert dirs[tag] == str(run / "emb")
    for i, tid in enumerate(ids):
        port = os.path.join(dirs["port"], f"{tid}.{fmt}")
        jax_ = os.path.join(dirs["jax"], f"{tid}.{fmt}")
        if fmt == "npy":
            with open(port, "rb") as a, open(jax_, "rb") as b:
                assert a.read() == b.read()
            want = keep if tid == "tr2" else emb[i]
            np.testing.assert_array_equal(np.load(port), want)
        else:
            assert torch.equal(torch.load(port, weights_only=True),
                               torch.load(jax_, weights_only=True))
            np.testing.assert_array_equal(
                torch.load(port, weights_only=True).numpy(), emb[i])
