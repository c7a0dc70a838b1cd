"""The port's eval slice (kNN sweep, metrics, rank eval, the Random /
Features / PinSage / PageRank rows, the artifact-cached harness, the
tables and CLI ``eval``) vs the JAX package, on the CPU at a small size.

Tolerances: kNN ids equal up to ties and scores within atol 1e-6 (both
f32-accurate products, summed in another order); the list metrics equal
within 1e-9 (the same numpy on the same lists); ``intra_diversity`` on the
torch path within 1e-5 relative (f32 sums in another order); the CLI's
CSVs allclose 1e-5.  ``Random`` lists are bit-equal, and ``PersPageRank``
fed the JAX package's uniforms gives its top-T ids exactly.  CLI ``eval``
with no ``--models`` writes every row of the JAX CLI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcn_song_embeddings_tpu import cli as jcli
from gcn_song_embeddings_tpu.evals import harness as jharness
from gcn_song_embeddings_tpu.evals import metrics as JM
from gcn_song_embeddings_tpu.evals import tables as jtables
from gcn_song_embeddings_tpu.evals.device_eval import (
    _rank_block as j_rank_block,
)
from gcn_song_embeddings_tpu.evals.device_eval import rank_eval as j_rank_eval
from gcn_song_embeddings_tpu.models.baselines import (
    PersPageRank as JPersPageRank,
)
from gcn_song_embeddings_tpu.models.baselines import Random as JRandom
from gcn_song_embeddings_tpu.ops.knn import knn_from_emb as j_knn
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.evals import harness
from gcn_song_embeddings_tpu_torch.evals import metrics as M
from gcn_song_embeddings_tpu_torch.evals import tables
from gcn_song_embeddings_tpu_torch.evals.device_eval import (
    pair_ranks,
    rank_eval,
    unit_rows,
)
from gcn_song_embeddings_tpu_torch.models.baselines import (
    EmbLoader,
    PersPageRank,
    Random,
)
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from torch_threads import one_torch_thread  # noqa: F401

TIMES = ("t (train)", "t (emb)", "t (knn)")


def _emb(n=400, d=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _same_up_to_ties(got_w, got_n, want_w, want_n, atol=1e-6):
    """Scores within atol; ids equal wherever the score is not tied (within
    atol) with a neighbor in the list."""
    np.testing.assert_allclose(got_w, want_w, atol=atol)
    w = want_w.astype(np.float64)
    tied = np.zeros(w.shape, bool)
    close = np.abs(np.diff(w, axis=1)) <= 2 * atol
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    assert np.array_equal(got_n[~tied], want_n[~tied])


@pytest.mark.parametrize("streamed,chunk", [(False, None), (True, 64),
                                            (True, 1000)])
def test_knn_from_emb_matches_jax(streamed, chunk):
    emb = _emb(700, 12, seed=1)
    queries = np.arange(3, 700, 7)
    kw = {"chunk": chunk} if chunk else {}
    got_w, got_n = knn_from_emb(emb, queries, k=25, streamed=streamed,
                                device="cpu", batch_size=40, **kw)
    want_w, want_n = j_knn(emb, queries, k=25, streamed=streamed)
    assert got_w.dtype == np.float32 and got_n.dtype == np.int32
    assert got_n.shape == (len(queries), 25)
    _same_up_to_ties(got_w, got_n, want_w, want_n)
    # k clamps to N - 1, every row by default
    w, n = knn_from_emb(emb[:10], k=50, device="cpu")
    assert n.shape == (10, 9) and not (n == np.arange(10)[:, None]).any()


def _knn_lists(n=300, k=120, seed=2):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n)[:k] for _ in range(n)])


def test_metrics_match_jax(positives):
    knn = _knn_lists(500, 150)
    pairs = positives[:400]
    deg = np.random.default_rng(3).integers(1, 9, size=620)
    feats = _emb(500, 20, seed=4)
    for k in (1, 10, 100):
        assert abs(M.hit_rate(knn, pairs, k) - JM.hit_rate(knn, pairs, k)) \
            <= 1e-9
        assert abs(M.mrr(knn, pairs, k) - JM.mrr(knn, pairs, k)) <= 1e-9
    for got, want in (
            (M.intra_diversity(knn, pairs, 50, feats),
             JM.intra_diversity(knn, pairs, 50, feats)),
            (M.inter_diversity(knn, pairs, 100, n_pairs=3000, seed=5),
             JM.inter_diversity(knn, pairs, 100, n_pairs=3000, seed=5)),
            (M.coverage(knn, pairs, K=100), JM.coverage(knn, pairs, K=100)),
            (M.coverage(knn, pairs, 100, all_nodes=False),
             JM.coverage(knn, pairs, 100, all_nodes=False)),
            (M.average_degree(knn, deg, pairs, 100),
             JM.average_degree(knn, deg, pairs, 100)),
            (M.low_degree_accuracy(knn, deg, pairs, 100, 3, M.mrr),
             JM.low_degree_accuracy(knn, deg, pairs, 100, 3, JM.mrr)),
            (M.low_co_accuracy(knn, pairs, 100, 1, M.hit_rate),
             JM.low_co_accuracy(knn, pairs, 100, 1, JM.hit_rate))):
        assert abs(got - want) <= 1e-9
    for a, b in zip(M.degree_dist(knn, deg, 100),
                    JM.degree_dist(knn, deg, 100)):
        np.testing.assert_array_equal(a, b)
    assert M.hit_rate(knn, pairs[:0], 10) == 0.0 == M.mrr(knn, pairs[:0], 10)


def test_intra_diversity_on_the_torch_path():
    knn = _knn_lists(300, 100, seed=6)
    feats = _emb(300, 24, seed=7)
    want = JM.intra_diversity(knn, None, 100, feats)
    got = M.intra_diversity(knn, None, 100, feats, batch=64, device="cpu")
    assert abs(got - want) <= 1e-5 * abs(want)


def test_rank_eval_ranks_match_jax_on_continuous_embeddings(positives):
    emb = _emb(500, 16, seed=8)
    pairs = positives[:300].astype(np.int32)
    unit = unit_rows(emb)
    want = np.asarray(j_rank_block(jnp.asarray(unit), jnp.asarray(pairs[:, 0]),
                                   jnp.asarray(pairs[:, 1]), chunk=128))
    got = pair_ranks(torch.as_tensor(unit), torch.as_tensor(pairs[:, 0]),
                     torch.as_tensor(pairs[:, 1]), chunk=128).numpy()
    np.testing.assert_array_equal(got, want)
    kw = dict(hit_ks=(1, 10, 100), mrr_k=200)
    got = rank_eval(emb, pairs, batch=64, chunk=100, device="cpu", **kw)
    want = j_rank_eval(emb, pairs, batch=64, **kw)
    assert got == want


@pytest.mark.parametrize("d", [256, 512])
def test_rank_eval_matches_jax_at_the_wide_arms_widths(positives, d):
    """The co-listen A/B's wide arms embed at out 256 and 512: there too
    the port's tie-fair average ranks and metrics equal JAX's, on rows
    that tie (every fifth row repeats an earlier one) as the hard
    benchmark's embeddings do."""
    emb = _emb(500, d, seed=9)
    emb[::5] = emb[1::5][:len(emb[::5])]
    pairs = positives[:300].astype(np.int32)
    unit = unit_rows(emb)
    want = np.asarray(j_rank_block(jnp.asarray(unit), jnp.asarray(pairs[:, 0]),
                                   jnp.asarray(pairs[:, 1]), chunk=128))
    got = pair_ranks(torch.as_tensor(unit), torch.as_tensor(pairs[:, 0]),
                     torch.as_tensor(pairs[:, 1]), chunk=128).numpy()
    assert (got != np.round(got)).any()          # some pairs tie
    np.testing.assert_array_equal(got, want)
    kw = dict(hit_ks=(10, 100, 500), mrr_k=1000)
    got = rank_eval(emb, pairs, batch=64, chunk=100, device="cpu", **kw)
    assert got == j_rank_eval(emb, pairs, batch=64, **kw)


def test_rank_eval_duplicate_rows_average_rank():
    """tests/test_metrics.py's tie case: a positive tied with m duplicates
    ranks 1 + #better + m/2, odd m included."""
    d = 8
    base = np.eye(d, dtype=np.float32)
    q = base[0]
    better = 0.9 * q + np.sqrt(1 - 0.81) * base[1]
    tied = 0.5 * q + np.sqrt(1 - 0.25) * base[2]
    pairs = np.array([[0, 3]])
    for m, ks in ((5, (2, 4, 8)), (4, (3, 4))):
        emb = np.stack([q, better, base[3]] + [tied] * m)
        got = rank_eval(emb, pairs, hit_ks=ks, mrr_k=10, batch=1,
                        device="cpu")
        assert got == j_rank_eval(emb, pairs, hit_ks=ks, mrr_k=10, batch=1)
        rank = 2 + (m - 1) / 2
        assert got["mrr@10"] == pytest.approx(1.0 / rank)
        unit = torch.as_tensor(unit_rows(emb))
        assert float(pair_ranks(unit, torch.tensor([0]),
                                torch.tensor([3]))[0]) == rank


def test_random_lists_bit_equal(graph):
    for k in (40, 200):      # oversampled, and per-query permutations
        got, want = Random(seed=3), JRandom(seed=3)
        got.train(graph, graph.track_ids, None, None, None)
        want.train(graph, graph.track_ids, None, None, None)
        for nodes in (np.arange(0, 37), np.arange(100, 300)):
            gw, gn = got.knn(nodes, k)
            ww, wn = want.knn(nodes, k)
            np.testing.assert_array_equal(gn, wn)
            np.testing.assert_array_equal(gw, ww)


@pytest.mark.parametrize("copies", [0, 1])
def test_pers_pagerank_with_jax_uniforms_matches(graph, positives, copies):
    """The JAX row draws block ``start``'s uniforms from fold_in(key,
    start) over its padded [batch] block; fed those, the port's walks and
    top-T equal JAX's exactly (the last, partial block included)."""
    n_hops, bs, k, seed = 60, 64, 20, 4
    train_pos = positives[:800]
    want = JPersPageRank(n_hops=n_hops, seed=seed, batch_size=bs,
                         colisten_copies=copies)
    want.train(graph, graph.track_ids, train_pos, None, None)
    port_graph = SongGraph(graph.base_dir)
    got = PersPageRank(n_hops=n_hops, seed=seed, batch_size=bs,
                       colisten_copies=copies, device="cpu")
    got.train(port_graph, port_graph.track_ids, train_pos, None, None)

    def jax_uniforms(start, n_walkers):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), start)
        u = np.asarray(jax.random.uniform(key, (n_hops, bs, 3)))
        return torch.from_numpy(u[:, :n_walkers].copy())

    got.uniforms = jax_uniforms
    nodes = np.arange(5, 5 + 150)
    gw, gn = got.knn(nodes, k)
    ww, wn = want.knn(nodes, k)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gw, ww)
    # its own generator: rows of distinct visits, self never listed
    own = PersPageRank(n_hops=n_hops, seed=seed, batch_size=bs,
                       colisten_copies=copies, device="cpu")
    own.train(port_graph, port_graph.track_ids, train_pos, None, None)
    w, n = own.knn(nodes, k)
    assert n.shape == (150, k) and (w[:, 0] > 0).all()
    assert not ((n == nodes[:, None]) & (w > 0)).any()


def test_harness_cache_is_read_by_both_packages(graph, positives, tmp_path):
    emb_path = str(tmp_path / "emb.npy")
    np.save(emb_path, _emb(graph.n_items, 8, seed=9))
    train, test = positives[:1000], positives[1000:]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    harness.precompute_model(EmbLoader(emb_path, device="cpu"), "E", graph,
                             graph.track_ids, train, test, None, port_dir,
                             k=30, verbose=False)
    harness.precompute_model(Random(), "R", graph, graph.track_ids, train,
                             test, None, port_dir, k=30, verbose=False)
    from gcn_song_embeddings_tpu.models.baselines import EmbLoader as JEmb

    jharness.precompute_model(JEmb(emb_path), "E", graph, graph.track_ids,
                              train, test, None, jax_dir, k=30,
                              verbose=False)
    for name in ("E", "R"):
        got = jharness.load_knn(name, port_dir)       # JAX reads the port's
        assert got[0].dtype == np.float32 and got[1].shape == (500, 30)
        port_view = harness.load_knn(name, port_dir)
        for a, b in zip(got, port_view):
            np.testing.assert_array_equal(a, b)
    a, b = harness.load_knn("E", jax_dir), harness.load_knn("E", port_dir)
    _same_up_to_ties(b[0], b[1], a[0], a[1])
    np.testing.assert_array_equal(harness.load_embedding("E", jax_dir),
                                  jharness.load_embedding("E", port_dir))
    lazy = harness.get_knn_dict({"R": Random()}, graph, graph.track_ids,
                                train, test, None, port_dir, k=30,
                                verbose=False)
    assert list(lazy) == ["R"] and len(lazy) == 1
    assert lazy.get_times("R")[2] >= 0.0
    np.testing.assert_array_equal(lazy["R"][1],
                                  jharness.load_knn("R", port_dir)[1])


def test_threaded_cache_writes_equal_the_serial_ones(graph, positives,
                                                     tmp_path):
    """``get_knn_dict`` compresses each row's cache on a writer thread;
    every cache it leaves equals ``precompute_model``'s written in
    line, for more rows than writer threads."""
    train, test = positives[:1000], positives[1000:]
    models, serial = {}, str(tmp_path / "serial")
    for i in range(harness.KNN_WRITERS + 2):
        path = str(tmp_path / f"emb{i}.npy")
        np.save(path, _emb(graph.n_items, 8, seed=20 + i))
        models[f"E{i}"] = EmbLoader(path, device="cpu")
        harness.precompute_model(models[f"E{i}"], f"E{i}", graph,
                                 graph.track_ids, train, test, None, serial,
                                 k=40, verbose=False)
    lazy = harness.get_knn_dict(models, graph, graph.track_ids, train, test,
                                None, str(tmp_path / "threaded"), k=40,
                                verbose=False)
    for name in models:
        got, want = lazy[name], harness.load_knn(name, serial)[:2]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_a_failed_cache_write_is_raised(graph, positives, tmp_path,
                                        monkeypatch):
    emb_path = str(tmp_path / "emb.npy")
    np.save(emb_path, _emb(graph.n_items, 8, seed=30))

    def failing(path, **arrays):
        raise OSError(f"disk full writing {path}")

    monkeypatch.setattr(harness.np, "savez_compressed", failing)
    with pytest.raises(OSError, match="disk full"):
        harness.get_knn_dict({"E": EmbLoader(emb_path, device="cpu")},
                             graph, graph.track_ids, positives[:1000],
                             positives[1000:], None, str(tmp_path / "c"),
                             k=20, verbose=False)


def test_tables_match_pandas_tables(graph, positives, tmp_path):
    knn = {"A": (None, _knn_lists(500, 120, seed=10)),
           "B,c": (None, _knn_lists(500, 120, seed=11))}
    test = positives[1000:]
    feats = _emb(500, 12, seed=12)
    deg = graph.in_degrees()
    for port, ref in (
            (tables.compute_results_table(knn, test, deg),
             jtables.compute_results_table(knn, test, deg)),
            (tables.compute_beyond_accuracy_table(knn, test, deg, feats),
             jtables.compute_beyond_accuracy_table(knn, test, deg, feats))):
        assert port.columns == list(ref.columns)
        assert list(port.rows) == list(ref.index)
        port.to_csv(str(tmp_path / "p.csv"))
        ref.to_csv(str(tmp_path / "r.csv"))
        got, want = (pd.read_csv(tmp_path / f, index_col=0)
                     for f in ("p.csv", "r.csv"))
        assert open(tmp_path / "p.csv").readline() == \
            open(tmp_path / "r.csv").readline()
        pd.testing.assert_frame_equal(got, want, rtol=0, atol=1e-12)
        assert "A" in port.to_string()


@pytest.fixture(scope="module")
def eval_run(dataset_dir, tmp_path_factory):
    """One emb.npy under runs/r, evaluated by both CLIs into their own
    eval dirs."""
    work = tmp_path_factory.mktemp("eval_cli")
    runs = work / "runs"
    (runs / "r").mkdir(parents=True)
    np.save(runs / "r" / "emb.npy", _emb(500, 16, seed=13))
    args = ["--dataset", dataset_dir, "--run-dir", str(runs),
            "--pinsage-runs", "r", "--k", "60",
            "--models", "Random", "Features", "PinSage:r"]
    jcli.main(["eval", *args, "--eval-dir", str(work / "jax")])
    cli.main(["eval", *args, "--eval-dir", str(work / "port"),
              "--device", "cpu"])
    return work


def test_cli_eval_csvs_match_jax(eval_run, dataset_dir):
    for name in ("results_accuracy.csv", "results_beyond.csv"):
        got = pd.read_csv(eval_run / "port" / name, index_col=0)
        want = pd.read_csv(eval_run / "jax" / name, index_col=0)
        assert list(got.index) == list(want.index) == [
            "Random", "Features", "PinSage:r"]
        assert list(got.columns) == list(want.columns)
        cols = [c for c in want.columns if c not in TIMES]
        np.testing.assert_allclose(got[cols].to_numpy(),
                                   want[cols].to_numpy(), rtol=1e-5,
                                   atol=1e-5)
    for model in ("Random", "Features", "PinSage:r"):
        got = harness.load_knn(model, str(eval_run / "port"))
        want = jharness.load_knn(model, str(eval_run / "jax"))
        if model == "Random":
            np.testing.assert_array_equal(got[1], want[1])
        else:
            _same_up_to_ties(got[0], got[1], want[0], want[1])
    # the Features row scores the raw features file, not z-normalized
    np.testing.assert_array_equal(
        np.load(eval_run / "port" / "emb" / "Features.npy"),
        np.load(os.path.join(dataset_dir, "features.npy")))


def test_cli_eval_refuses_rows_the_port_does_not_have(dataset_dir,
                                                      tmp_path, capsys):
    """Every row of the JAX CLI is in the port now: the rows it still
    refuses are the ones neither package has (an unknown name, a Hybrid
    row without --hybrid-runs), and nothing is written for them."""
    base = ["eval", "--dataset", dataset_dir, "--device", "cpu",
            "--eval-dir", str(tmp_path / "ev"), "--k", "20"]
    for extra in (["--models", "Nope"], ["--models", "Random", "Hybrid:r"],
                  ["--hybrid-runs", "r", "--models", "Hybrid:s"]):
        with pytest.raises(SystemExit, match="unknown models"):
            cli.main(base + extra)
    assert not os.path.exists(tmp_path / "ev")
    cli.main(base + ["--models", "Random", "JaccardFast"])
    assert "rows left out" not in capsys.readouterr().out
    acc = pd.read_csv(tmp_path / "ev" / "results_accuracy.csv", index_col=0)
    assert list(acc.index) == ["Random", "JaccardFast"]
    # JaccardFast keeps the reference's k-1 wide lists
    assert harness.load_knn("JaccardFast", str(tmp_path / "ev"))[1].shape \
        == (500, 19)


def test_cli_eval_with_no_models_runs_every_jax_row(dataset_dir, tmp_path,
                                                    monkeypatch):
    """``eval`` with no ``--models`` builds every row JAX's ``cmd_eval``
    builds (its names captured from the JAX CLI itself), ``--hybrid-runs``
    included, and writes both CSVs with JAX's rows and columns.  The GNN
    rows train 20 steps and node2vec 1 epoch here, to keep the CPU run
    short; every other row runs at its defaults."""
    runs = tmp_path / "runs"
    (runs / "r").mkdir(parents=True)
    np.save(runs / "r" / "emb.npy", _emb(500, 16, seed=14))
    args = ["eval", "--dataset", dataset_dir, "--run-dir", str(runs),
            "--pinsage-runs", "r", "--hybrid-runs", "r", "--k", "30"]

    class Built(Exception):
        pass

    def capture(models, *rest, **kw):
        raise Built(list(models))

    monkeypatch.setattr(jharness, "get_knn_dict", capture)
    with pytest.raises(Built) as built:
        jcli.main(args + ["--eval-dir", str(tmp_path / "jax")])
    jax_rows = built.value.args[0]
    assert len(jax_rows) == 15 and "Hybrid:r" in jax_rows

    build = cli.eval_models

    def cut(args, graph, device):
        models = build(args, graph, device)
        for name in ("GraphSAGE", "GAT", "GCN"):
            models[name].kwargs["steps"] = 20
        models["Node2Vec"].epochs = 1
        return models

    monkeypatch.setattr(cli, "eval_models", cut)
    ev = tmp_path / "port"
    cli.main(args + ["--eval-dir", str(ev), "--device", "cpu"])
    knn = harness.LazyKnnDict(jax_rows, str(ev))
    test_pos = SongGraph(dataset_dir).load_positives_split(
        os.path.join(dataset_dir, "positives.json"))[1]
    feats = np.load(os.path.join(dataset_dir, "features.npy"))
    deg = SongGraph(dataset_dir).in_degrees()
    for name, ref in (
            ("results_accuracy.csv",
             jtables.compute_results_table(knn, test_pos, deg)),
            ("results_beyond.csv",
             jtables.compute_beyond_accuracy_table(knn, test_pos, deg,
                                                   feats))):
        got = pd.read_csv(ev / name, index_col=0)
        assert list(got.index) == jax_rows == list(ref.index)
        assert list(got.columns) == list(ref.columns)
        assert np.isfinite(got.to_numpy()).all()
    for row in jax_rows:
        n = harness.load_knn(row, str(ev))[1]
        assert n.shape == (500, 29 if row == "JaccardFast" else 30), row
