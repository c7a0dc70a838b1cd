"""The port's data layer (``SongGraph`` with feature directories, the
native readers, graph statistics and sparse matrices, the hard and large
synthetic datasets, the CLI's feature and positives resolution) vs the
JAX package, on the CPU at a small size.

Integer and structural outputs are held equal; the feature matrices
too (both packages stack the same f32 rows and z-normalize them with the
same numpy calls).  The JAX package's native readers are built from the
same sources with native/Makefile's flags.
"""

import json
import os
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu import cli as jcli
from gcn_song_embeddings_tpu.data import graph as jgraph
from gcn_song_embeddings_tpu.data import synth as jsynth
from gcn_song_embeddings_tpu.native import featload as jfeatload
from gcn_song_embeddings_tpu.native import jsongraph as jjsongraph
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.data import graph as tgraph
from gcn_song_embeddings_tpu_torch.data import synth as tsynth
from gcn_song_embeddings_tpu_torch.native import build
from gcn_song_embeddings_tpu_torch.native import featload, jsongraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native readers, built with native/Makefile's
    flags into this module's own directory and loaded from there (so no
    other test's build of native/ is raced)."""
    out = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, extra in ((jjsongraph, "jsongraph", ()),
                                 (jfeatload, "featload", ("-pthread",))):
            lib = str(out / f"lib{name}.so")
            subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared",
                            *extra, "-o", lib,
                            os.path.join(REPO, "native", f"{name}.cc")],
                           check=True, capture_output=True)
            mp.setattr(mod, "_LIB_PATH", lib)
            mp.setattr(mod, "_lib", None)
        assert jfeatload.native_available() and jjsongraph.native_available()
        yield


def _feature_dir(path, track_ids, dim=24, seed=0):
    """Per-track files: f32 .npy, f64 .npy, [1, d] .npy and .pt in turn;
    returns the f32 matrix they hold."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i, tid in enumerate(track_ids):
        vec = rng.normal(size=dim)
        kind = i % 4
        if kind == 0:
            np.save(os.path.join(path, tid + ".npy"), vec.astype(np.float32))
        elif kind == 1:
            np.save(os.path.join(path, tid + ".npy"), vec)
        elif kind == 2:
            np.save(os.path.join(path, tid + ".npy"),
                    vec.astype(np.float32)[None, :])
        else:
            torch.save(torch.tensor(vec.astype(np.float32)),
                       os.path.join(path, tid + ".pt"))
        rows.append(vec.astype(np.float32))
    return np.stack(rows)


def _same_graph(a, b):
    for csr in ("i2c", "c2i"):
        np.testing.assert_array_equal(getattr(a, csr).indptr,
                                      getattr(b, csr).indptr)
        np.testing.assert_array_equal(getattr(a, csr).indices,
                                      getattr(b, csr).indices)
    assert a.track_ids == b.track_ids and a.col_ids == b.col_ids


def test_song_graph_with_a_feature_dir_matches_jax(dataset_dir, tmp_path,
                                                   jax_native):
    ids = jgraph.SongGraph(dataset_dir).track_ids
    raw = _feature_dir(str(tmp_path / "features_mixed"), ids)
    want = jgraph.SongGraph(dataset_dir,
                            features_dir=str(tmp_path / "features_mixed"))
    got = tgraph.SongGraph(dataset_dir,
                           features_dir=str(tmp_path / "features_mixed"))
    _same_graph(got, want)
    assert got.edge_reader == "native"
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_allclose(
        got.features, tgraph.z_normalize(raw), atol=1e-6)
    # a file wins over the directory, as in the JAX package
    both = tgraph.SongGraph(dataset_dir, features_dir=str(
        tmp_path / "features_mixed"), features_file=os.path.join(
            dataset_dir, "features.npy"))
    assert both.features.shape[1] == 32


def test_native_readers_match_jax_python_and_native(dataset_dir, tmp_path,
                                                    jax_native):
    graph = jgraph.SongGraph(dataset_dir)
    path = os.path.join(dataset_dir, "graph.json")
    src, dst, reader = jsongraph.load_edges(path, graph.index_map)
    assert reader == "native"
    for want in (jjsongraph._load_edges_python(path, graph.index_map),
                 jjsongraph.load_edges(path, graph.index_map),
                 jsongraph.load_edges_json(path, graph.index_map)):
        np.testing.assert_array_equal(src, want[0])
        np.testing.assert_array_equal(dst, want[1])
    ids = [f"trk{i:03d}" for i in range(41)]
    d = str(tmp_path / "feats")
    expect = _feature_dir(d, ids, dim=48, seed=3)
    got = featload.load_feature_rows(d, ids)
    np.testing.assert_array_equal(got, jfeatload.load_feature_rows(d, ids))
    np.testing.assert_array_equal(got, tgraph.load_feature_dir(d, ids))
    np.testing.assert_allclose(got, expect, atol=1e-6)
    # the Python path (no native reader) stacks the same rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(featload, "native_available", lambda: False)
        np.testing.assert_array_equal(tgraph.load_feature_dir(d, ids), got)


def test_native_reader_rejects_big_endian_then_np_load_reads_it(tmp_path,
                                                              jax_native):
    vec = np.arange(6, dtype=np.float32)
    np.save(tmp_path / "a.npy", vec)
    np.save(tmp_path / "b.npy", (vec + 1).astype(">f4"))
    with pytest.warns(UserWarning, match="not loadable by the native"):
        got = featload.load_feature_rows(str(tmp_path), ["a", "b"])
    np.testing.assert_array_equal(got, np.stack([vec, vec + 1]))
    with pytest.warns(UserWarning):
        want = jfeatload.load_feature_rows(str(tmp_path), ["a", "b"])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        featload.load_feature_rows(str(tmp_path), ["a", "nope"])
    np.save(tmp_path / "c.npy", np.zeros(9, np.float32))
    with pytest.raises(ValueError, match="failed to load"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        featload.load_feature_rows(str(tmp_path), ["a", "c"])


def test_native_build_fallback_and_failure(dataset_dir, tmp_path,
                                           monkeypatch):
    """No compiler: the json module reads the edges and the graph says
    so.  A compiler whose build fails: the failure raises."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_compiler", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "empty_build")
    g = tgraph.SongGraph(dataset_dir)
    assert g.edge_reader == "json"
    assert not featload.native_available()
    _same_graph(g, jgraph.SongGraph(dataset_dir))
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "jsongraph.cc").write_text("this is not C++\n")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_compiler", lambda: shutil.which("g++"))
    monkeypatch.setattr(build, "SOURCE_DIR", broken)
    with pytest.raises(RuntimeError, match="failed"):
        jsongraph.native_available()
    assert str(build.library_path("jsongraph")).startswith(
        str(tmp_path / "empty_build"))


def test_stats_degrees_and_sparse_matrices_match_jax(dataset_dir,
                                                     positives):
    got = tgraph.SongGraph(dataset_dir)
    want = jgraph.SongGraph(dataset_dir)
    assert got.stats(positives) == want.stats(positives)
    assert got.stats() == want.stats()
    np.testing.assert_array_equal(got.in_degrees(), want.in_degrees())
    np.testing.assert_array_equal(got.in_degrees(np.array([0, 3, 501])),
                                  want.in_degrees(np.array([0, 3, 501])))
    assert got.song_info(7) == want.song_info(7)
    np.testing.assert_array_equal(
        tgraph.co_occurrence_counts(got.n_items, positives),
        jgraph.co_occurrence_counts(want.n_items, positives))
    for a, b in ((tgraph.track_track_matrix(got.n_items, positives),
                  jgraph.track_track_matrix(want.n_items, positives)),
                 (tgraph.col_track_matrix(got),
                  jgraph.col_track_matrix(want))):
        assert a.shape == b.shape and (a != b).nnz == 0


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("streamed", [False, True])
def test_hard_dataset_byte_identical(tmp_path, monkeypatch, streamed):
    """The dict writer and (past _STREAM_JSON_MIN tracks) the streamed
    writer, here forced at 2,000 tracks."""
    if streamed:
        monkeypatch.setattr(jsynth, "_STREAM_JSON_MIN", 0)
        monkeypatch.setattr(tsynth, "_STREAM_JSON_MIN", 0)
    kw = dict(n_tracks=2000, n_collections=300, n_positives=3000,
              feature_dim=16, seed=4)
    jsynth.make_hard_dataset(str(tmp_path / "j"), **kw)
    tsynth.make_hard_dataset(str(tmp_path / "t"), **kw)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert list(got) == list(want) and "latent.npz" in got
    for name in want:
        if name.endswith(".npz"):
            with np.load(tmp_path / "t" / name) as a, \
                    np.load(tmp_path / "j" / name) as b:
                assert a.files == b.files
                for key in a.files:
                    np.testing.assert_array_equal(a[key], b[key])
        else:
            assert got[name] == want[name], name
    # the streamed JSON is valid and parses to the same graph
    g = tgraph.SongGraph(str(tmp_path / "t"))
    assert g.n_items == 2000 and g.edge_reader == "native"


def test_large_dataset_byte_identical(tmp_path):
    kw = dict(n_tracks=3000, n_collections=400, n_clusters=30,
              tracks_per_collection=8, n_positives=2000, feature_dim=16,
              seed=5)
    jsynth.make_synthetic_dataset_large(str(tmp_path / "j"), **kw)
    tsynth.make_synthetic_dataset_large(str(tmp_path / "t"), **kw)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_ensure_hard_dataset_guard_matches_jax(tmp_path):
    kw = dict(n_tracks=1000, n_collections=150, n_positives=800, seed=1)
    for mod, name in ((jsynth, "j"), (tsynth, "t")):
        path = str(tmp_path / name)
        assert mod.ensure_hard_dataset(path, log=lambda *_: None, **kw) == \
            path
        assert open(os.path.join(path, "dataset_kind.txt")).read() == "hard"
        mod.ensure_hard_dataset(path, log=lambda *_: None, **kw)  # reuse
        plain = str(tmp_path / f"{name}_plain")
        jsynth.make_synthetic_dataset(plain, n_tracks=100, n_collections=20,
                                      n_positives=50)
        with pytest.raises(RuntimeError, match="HARD"):
            mod.ensure_hard_dataset(plain, log=lambda *_: None, **kw)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_cli_synth_hard_matches_jax(tmp_path):
    args = ["--n-tracks", "1000", "--n-collections", "120",
            "--n-positives", "900", "--feature-dim", "8", "--seed", "2",
            "--hard"]
    jcli.main(["synth", "--dataset", str(tmp_path / "j"), *args])
    cli.main(["synth", "--dataset", str(tmp_path / "t"), *args])
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_cli_resolves_features_and_positives_as_jax(dataset_dir, tmp_path):
    ds = str(tmp_path / "ds")
    shutil.copytree(dataset_dir, ds,
                    ignore=shutil.ignore_patterns("*.npz", "baselines"))
    os.remove(os.path.join(ds, "features.npy"))

    class Args:
        dataset, features, positives = ds, "mixed", None

    ids = tgraph.SongGraph(ds).track_ids
    _feature_dir(os.path.join(ds, "features_mixed"), ids, dim=12)
    rng = np.random.default_rng(0)
    np.save(os.path.join(ds, "features_other.npy"),
            rng.normal(size=(len(ids), 20)).astype(np.float32))
    np.save(os.path.join(ds, "features.npy"),
            rng.normal(size=(len(ids), 28)).astype(np.float32))
    for name, width in (("other", 20), ("mixed", 28)):
        Args.features = name
        got = cli.load_graph(ds, name)
        want = jcli._load_graph(Args)
        assert got.features.shape[1] == width
        np.testing.assert_array_equal(got.features, want.features)
    os.remove(os.path.join(ds, "features.npy"))
    Args.features = "mixed"
    np.testing.assert_array_equal(cli.load_graph(ds, "mixed").features,
                                  jcli._load_graph(Args).features)
    assert cli.load_graph(ds, "mixed", need_features=False).features is None
    # positives: the lfm file first; an explicit name must exist
    assert cli.positives_path(ds) == jcli._positives_path(Args)
    with open(os.path.join(ds, "positives.json")) as f:
        pairs = json.load(f)
    with open(os.path.join(ds, "positives_lfm.json"), "w") as f:
        json.dump(pairs[:100], f)
    assert cli.positives_path(ds) == jcli._positives_path(Args) == \
        os.path.join(ds, "positives_lfm.json")
    Args.positives = "positives.json"
    assert cli.positives_path(ds, "positives.json") == \
        jcli._positives_path(Args)
    Args.positives = "typo.json"
    for call in (lambda: cli.positives_path(ds, "typo.json"),
                 lambda: jcli._positives_path(Args)):
        with pytest.raises(FileNotFoundError, match="typo"):
            call()


def test_cli_stats_matches_jax(dataset_dir, capsys):
    jcli.main(["stats", "--dataset", dataset_dir])
    want = json.loads(capsys.readouterr().out)
    cli.main(["stats", "--dataset", dataset_dir])
    assert json.loads(capsys.readouterr().out) == want
    with pytest.raises(FileNotFoundError):
        cli.main(["stats", "--dataset", dataset_dir, "--positives",
                  "nope.json"])
