"""The port's tail modules (``data.explore``, ``evals.qualitative``,
``data.collector``, ``utils.profiling``) against the JAX package's, on the
CPU.

Both packages run on the same inputs and write into directories of their
own; the files must be equal byte for byte, the printed text equal, the
crawl's ranking equal when the port is fed the JAX walker's trace, and
the PCA coordinates within 1e-5 (two SVDs of the same f32 matrix; the
sign of each axis is fixed by the first row).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.data import SongGraph as JSongGraph
from gcn_song_embeddings_tpu.data import collector as jcollector
from gcn_song_embeddings_tpu.data import explore as jexplore
from gcn_song_embeddings_tpu.data.device import DeviceGraph as JDeviceGraph
from gcn_song_embeddings_tpu.evals import qualitative as jqual
from gcn_song_embeddings_tpu.ops.walks import random_walks as j_random_walks
from gcn_song_embeddings_tpu.utils import profiling as jprof
from gcn_song_embeddings_tpu_torch.data import collector, explore
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.data.synth import make_hard_dataset
from gcn_song_embeddings_tpu_torch.evals import qualitative as qual
from gcn_song_embeddings_tpu_torch.utils import profiling as prof
from torch_threads import one_torch_thread  # noqa: F401

PCA_ATOL = 1e-5


@pytest.fixture(scope="module")
def port_graph(dataset_dir):
    return SongGraph(dataset_dir,
                     features_file=os.path.join(dataset_dir, "features.npy"))


def _tree(root: str) -> dict[str, bytes]:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _same_tree(a: str, b: str) -> None:
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name] == tb[name], name


# ------------------------------------------------------------------ explore

def test_giant_component_is_jax_node_set(graph, port_graph):
    got = explore.giant_component(port_graph)
    np.testing.assert_array_equal(got, jexplore.giant_component(graph))
    assert len(got) > 0.9 * port_graph.n_nodes


@pytest.mark.parametrize("min_degree,max_degree", [(2, 10 ** 6), (4, 9)])
def test_make_mini_dataset_files_equal_jax(graph, port_graph, tmp_path,
                                           min_degree, max_degree):
    a = explore.make_mini_dataset(port_graph, str(tmp_path / "port"),
                                  min_degree, max_degree,
                                  features=port_graph.features)
    b = jexplore.make_mini_dataset(graph, str(tmp_path / "jax"), min_degree,
                                   max_degree, features=graph.features)
    _same_tree(a, b)
    mini = SongGraph(a, features_file=os.path.join(a, "features.npy"))
    assert 0 < mini.n_items <= port_graph.n_items
    assert mini.features.shape[0] == mini.n_items


def test_dataset_distributions_equal_pandas_csvs(graph, port_graph,
                                                 positives, tmp_path):
    """The port writes without pandas what the JAX package writes with
    ``pd.DataFrame((levels, counts)).to_csv``."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = explore.save_dataset_distributions(port_graph, positives,
                                             str(tmp_path / "port"))
    want = jexplore.save_dataset_distributions(graph, positives,
                                               str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_levels_csv_writes_float_levels_as_pandas_does(tmp_path):
    import pandas as pd

    for levels in (np.array([0.5, 2.0, 3.25]), np.array([1, 7, 9])):
        counts = np.array([3, 1, 2])
        explore._levels_csv(str(tmp_path / "a.csv"), levels, counts)
        pd.DataFrame((levels, counts)).to_csv(str(tmp_path / "b.csv"))
        assert ((tmp_path / "a.csv").read_bytes()
                == (tmp_path / "b.csv").read_bytes())


@pytest.mark.parametrize("start,num_steps,top", [(3, 2000, 5), (11, None, 10),
                                                 (40, 300, 8)])
def test_crawl_scores_from_jax_trace_equal_jax(graph, port_graph, start,
                                               num_steps, top):
    """The JAX crawl's walks (its threefry draws) scored by the port's
    ``crawl_scores`` give ``crawl_walk_counts``' list; the schedule is the
    same."""
    walkers, hops = explore.crawl_schedule(port_graph, start, num_steps)
    trace = np.asarray(j_random_walks(
        JDeviceGraph.from_graph(graph),
        jnp.full((walkers,), start, dtype=jnp.int32), hops, 0.85,
        jax.random.PRNGKey(0)))
    assert trace.shape == (walkers, hops)
    want = jexplore.crawl_walk_counts(graph, start, num_steps, 0, top)
    assert explore.crawl_scores(port_graph, trace, start, top) == want


def test_crawl_walk_counts_on_the_cpu(port_graph):
    out = explore.crawl_walk_counts(port_graph, start=3, num_steps=2000,
                                    top=5, device="cpu")
    assert 0 < len(out) <= 5
    assert all(s > 0 for _, s in out) and all(n != 3 for n, _ in out)
    assert out == explore.crawl_walk_counts(port_graph, 3, 2000, top=5,
                                            device="cpu")


# -------------------------------------------------------------- qualitative

def _knn(n_items, width=10, seed=0):
    rng = np.random.default_rng(seed)
    knn_n = np.stack([rng.permutation(n_items)[:width]
                      for _ in range(n_items)])
    return rng.random(knn_n.shape).astype(np.float32), knn_n


@pytest.fixture(scope="module")
def hard(tmp_path_factory):
    """tests/test_explore_qualitative.py's hard catalog, made by the port
    and read by both packages."""
    ds = make_hard_dataset(
        str(tmp_path_factory.mktemp("hard") / "ds"), n_tracks=400,
        tracks_per_artist=5, artists_per_genre=8, genres_per_group=2,
        n_collections=80, collection_size_range=(5, 30), n_positives=2000,
        feature_dim=16, seed=0)
    images = os.path.join(ds, "images")
    os.makedirs(images, exist_ok=True)
    with open(os.path.join(ds, "tracks.json")) as f:
        tracks = json.load(f)
    for info in list(tracks.values())[::3]:     # covers for some albums
        if info.get("album_id"):
            with open(os.path.join(images, info["album_id"] + ".jpg"),
                      "wb") as f:
                f.write(info["album_id"].encode())
    feats = os.path.join(ds, "features.npy")
    return (ds, SongGraph(ds, features_file=feats),
            JSongGraph(ds, features_file=feats))


def test_examples_tree_equals_jax(hard, tmp_path):
    """Lists, covers and figure.tex of several queries and models, as
    ``export_recommendation_lists`` writes them: byte-equal trees."""
    _, pg, jg = hard
    w, n = _knn(pg.n_items, seed=1)
    knn = {"Features": (w, n), "Random": (w, n[::-1].copy())}
    for pkg, g, root in ((qual, pg, "port"), (jqual, jg, "jax")):
        pkg.export_recommendation_lists(g, [7, 12, 300], knn,
                                        ["Features", "Random"], k=5,
                                        out_root=str(tmp_path / root))
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    song = pg.tracks[pg.track_ids[7]]["name"]
    assert sorted(os.listdir(tmp_path / "port" / song)) == [
        "Features", "Random", "covers", "figure.tex"]


def test_single_list_and_figure_with_a_template_equal_jax(hard, tmp_path):
    _, pg, jg = hard
    _, n = _knn(pg.n_items, seed=2)
    knn = {"M1": (None, n), "M2": (None, n[:, ::-1].copy())}
    template = tmp_path / "t.tex"
    template.write_text("<method_0> <title_0_0> <cover_1_2> <album_1_3>\n")
    for pkg, g, root in ((qual, pg, "port"), (jqual, jg, "jax")):
        out = str(tmp_path / root)
        pkg.export_recommendation_list(g, 5, n, "M1", k=4, out_root=out)
        pkg.export_recommendation_figure(g, 5, knn, ["M1", "M2"], k=4,
                                         out_root=out,
                                         template_path=str(template))
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_printed_text_equals_jax(graph, port_graph, tmp_path):
    """format_knn, format_query, the scripted crawl_embedding (random,
    crawl into rank 2, export, quit), knn_example, examine_knn_weights
    and examine_emb print what the JAX functions print."""
    w, n = _knn(port_graph.n_items, seed=3)
    knn = {"A": (w, n), "B": (w[::-1].copy(), n[::-1].copy())}
    deg = port_graph.in_degrees()
    assert qual.format_knn(port_graph, deg, w[4, :6], n[4, :6]) == \
        jqual.format_knn(graph, graph.in_degrees(), w[4, :6], n[4, :6])
    assert qual.format_query(9, port_graph) == jqual.format_query(9, graph)
    emb = np.random.default_rng(4).normal(
        size=(port_graph.n_items, 8)).astype(np.float32)
    os.makedirs(tmp_path / "emb")
    np.save(tmp_path / "emb" / "M.npy", emb)

    def run(pkg, g, root):
        lines = []
        replies = iter(["r", "2", "e", "x", "q"])
        cwd = os.getcwd()
        os.makedirs(root)
        os.chdir(root)
        try:
            pkg.crawl_embedding(knn, g, K=5, seed=1,
                                input_fn=lambda _: next(replies),
                                print_fn=lines.append)
        finally:
            os.chdir(cwd)
        pkg.knn_example(emb, 3, 4, g, seed=2, print_fn=lines.append)
        pkg.examine_emb(["M"], str(tmp_path), print_fn=lines.append)
        return lines

    port = run(qual, port_graph, str(tmp_path / "port"))
    assert port == run(jqual, graph, str(tmp_path / "jax"))
    assert any("Nearest neighbors:" in line for line in port)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_examine_knn_weights_prints_as_jax(capsys):
    w, n = _knn(40, width=120, seed=5)
    jqual.examine_knn_weights({"A": (w, n)})
    want = capsys.readouterr().out
    qual.examine_knn_weights({"A": (w, n)})
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("rows,sample", [(300, 2000), (500, 120)])
def test_pca_projection_matches_jax_plot(monkeypatch, tmp_path, rows,
                                         sample):
    """The coordinates JAX's ``plot_embedding_projection`` scatters
    (captured from its ``plt.scatter`` call) against the port's
    ``pca_projection``, within 1e-5 after fixing each axis's sign."""
    import matplotlib.pyplot as plt

    emb = np.random.default_rng(6).normal(size=(rows, 12)).astype(
        np.float32)
    seen = {}
    monkeypatch.setattr(plt, "scatter", lambda x, y, **kw: seen.update(
        x=np.asarray(x), y=np.asarray(y)))
    jqual.plot_embedding_projection(emb, str(tmp_path / "j.png"),
                                    sample=sample, seed=3)
    idx, proj = qual.pca_projection(emb, sample=sample, seed=3)
    assert len(idx) == min(rows, sample)
    want = np.stack([seen["x"], seen["y"]], axis=1)
    sign = np.sign(proj[0]) * np.sign(want[0])
    np.testing.assert_allclose(proj * sign, want, atol=PCA_ATOL)


def test_plot_embedding_projection_writes_a_png(tmp_path):
    emb = np.random.default_rng(7).normal(size=(200, 8)).astype(np.float32)
    path = qual.plot_embedding_projection(
        emb, str(tmp_path / "p.png"), labels=np.arange(200) % 5)
    assert os.path.getsize(path) > 1000


# ---------------------------------------------------------------- collector

def _collect(pkg, d, seeds=(1, 2)):
    """Two collectors on one directory: the second resumes the first."""
    c1 = pkg.DatasetCollector(d, pkg.SyntheticSource(seed=seeds[0]),
                              seed=seeds[0])
    added = [c1.collect(n_batches=5)]
    c2 = pkg.DatasetCollector(d, pkg.SyntheticSource(seed=seeds[1]),
                              seed=seeds[1])
    added.append(c2.collect(n_batches=4, max_tracks=20))
    return c2, added


def test_collector_tree_after_a_resumed_run_equals_jax(tmp_path):
    port, got = _collect(collector, str(tmp_path / "port"))
    _, want = _collect(jcollector, str(tmp_path / "jax"))
    assert got == want
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    g = SongGraph(str(tmp_path / "port"))
    assert g.n_items == len(port.track_dict) and g.i2c.nnz == g.c2i.nnz


def test_collector_media_sweeps_and_backfill_equal_jax(tmp_path):
    """Clip and image sweeps with a flaky fetcher (retries), an orphan
    removed, the backfill and the track->image map: the same stats,
    files and JSON as the JAX collector."""
    def drive(pkg, d):
        c = pkg.DatasetCollector(d, seed=3)
        c.collect(n_batches=2)
        calls = {"n": 0}

        def flaky(key, url):
            calls["n"] += 1
            if calls["n"] % 5 == 1:
                raise IOError("transient")
            return b"data-" + key.encode()

        stats = [c.download_clips(flaky, retries=3)]
        del c.track_dict[next(iter(c.track_dict))]
        stats.append(c.download_clips(flaky))
        stats.append(c.download_images(lambda k, u: b"jpg-" + k.encode()))
        tid = next(iter(c.track_dict))
        c.track_dict[tid].pop("album", None)
        stats.append(c.backfill_metadata(
            lambda t: {"album": "Filled " + t, "artist_genres": ["g"]}))
        imap = {t: os.path.relpath(p, d)
                for t, p in c.track_image_map().items()}
        return stats, imap

    got = drive(collector, str(tmp_path / "port"))
    assert got == drive(jcollector, str(tmp_path / "jax"))
    assert got[0][0]["downloaded"] > 0 and got[0][1]["orphans"] == 1
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_synthetic_source_draws_the_jax_catalog():
    a, b = collector.SyntheticSource(seed=5), jcollector.SyntheticSource(
        seed=5)
    for q in ("a", "zq"):
        assert (a.search_collections(q, 3, "playlist")
                == b.search_collections(q, 3, "playlist"))
    import random

    ra, rb = random.Random(9), random.Random(9)
    assert [collector.random_query(ra) for _ in range(20)] == [
        jcollector.random_query(rb) for _ in range(20)]


# ---------------------------------------------------------------- profiling

def test_metrics_logger_lines_equal_jax(tmp_path):
    rows = [{"Train Loss": 1.0, "epoch": 0},
            {"Gradient Norm": 0.5, "Learning Rate": 1e-3, "x": [1, 2]}]
    a = prof.MetricsLogger(str(tmp_path / "a.jsonl"))
    b = jprof.MetricsLogger(str(tmp_path / "b.jsonl"))
    for row in rows:
        a.log(row)
        b.log(row)
    assert ((tmp_path / "a.jsonl").read_bytes()
            == (tmp_path / "b.jsonl").read_bytes())


def test_timer_throughput_and_sync_on_the_cpu():
    t = prof.Timer()
    x = torch.arange(10.0)
    for _ in range(2):
        with t.phase("a", sync_value={"x": [x, (x, 1)]}):
            x = x + 1
    with t.phase("b"):
        pass
    assert set(t.times) == {"a", "b"} and min(t.times.values()) >= 0
    assert json.loads(t.to_json()) == t.times
    prof.sync([x, {"y": x}, 3])
    assert prof.throughput(1000, 2.0) == jprof.throughput(1000, 2.0)
    assert prof.throughput(5, 0.0, "hops") == jprof.throughput(5, 0.0,
                                                               "hops")


def test_device_profile_writes_a_trace(tmp_path):
    with prof.device_profile(str(tmp_path / "trace")) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in p.key_averages())
