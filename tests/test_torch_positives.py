"""The port's positive generators vs the JAX package's ``data/positives.py``:
bit-equal on the same inputs (the same numpy draws, the same joins), the
LFM chain on the JAX tests' own fixtures, and the pandas-free TSV reader
equal to pandas' ``read_csv(sep="\\t", header=None,
on_bad_lines="skip")``."""

import json

import numpy as np
import pandas as pd
import pytest

from gcn_song_embeddings_tpu.data import positives as J
from gcn_song_embeddings_tpu_torch.data import positives as P


def _nbhds(n, t, seed):
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, n, (n, t)).astype(np.int32)
    weights = np.sort(rng.random((n, t)).astype(np.float32), 1)[:, ::-1]
    weights[rng.random((n, t)) < 0.1] = 0.0        # some empty slots
    return np.ascontiguousarray(weights), nodes


@pytest.mark.parametrize("m,max_rank,seed", [(200, 3, 0), (None, 3, 1),
                                             (500, 5, 7)])
def test_walk_positives_bit_equal(tmp_path, m, max_rank, seed):
    nb = _nbhds(60, 10, seed)
    out = tmp_path / "pos.json"
    got = P.generate_walk_positives(nb, 60, m=m, max_rank=max_rank,
                                    seed=seed, out_path=str(out))
    assert got == J.generate_walk_positives(nb, 60, m=m, max_rank=max_rank,
                                            seed=seed)
    assert json.loads(out.read_text()) == got
    for p in got:          # b sits at some rank < max_rank with weight > 0
        w, n = nb[0][p["a"], :max_rank], nb[1][p["a"], :max_rank]
        assert ((n == p["b"]) & (w > 0)).any()


@pytest.mark.parametrize("n,m,seed", [(100, 500, 1), (3, 50, 2)])
def test_random_positives_bit_equal(n, m, seed):
    got = P.generate_random_positives(n, m, seed=seed)
    assert got == J.generate_random_positives(n, m, seed=seed)
    assert all(p["a"] != p["b"] for p in got)


def test_indices_to_id_pairs_equal():
    pairs = P.generate_random_positives(20, 40, seed=3)
    ids = [f"tr{i}" for i in range(20)]
    assert P.indices_to_id_pairs(pairs, ids) == \
        J.indices_to_id_pairs(pairs, ids)


def test_lfm_positives_adjacency_and_dt():
    events = [(1, "a", 0.0), (1, "b", 100.0), (1, "c", 10000.0),
              (2, "d", 50.0), (2, "e", 60.0), (2, "e", 70.0)]
    for dt in (3600.0, 50.0, 1e6):
        assert P.generate_lfm_positives(events, max_delta_t=dt) == \
            J.generate_lfm_positives(events, max_delta_t=dt)
    assert {(p["a"], p["b"]) for p in P.generate_lfm_positives(events)} \
        == {("a", "b"), ("d", "e")}


@pytest.mark.parametrize("use_album", [False, True])
def test_lfm_catalog_matching_equal(use_album):
    tracks = {"id1": {"name": "Song One", "artist": "The Band",
                      "album": "X"},
              "id2": {"name": "Other", "artist": "Someone"},
              "id3": {"name": " song one ", "artist": "THE BAND"}}
    assert P.build_catalog_map(tracks, use_album) == \
        J.build_catalog_map(tracks, use_album)
    raw = [(7, "The Band", "alb", "song ONE", 12.0),
           (7, "Nobody", "alb", "unknown", 13.0),
           (8, "Someone", "alb", "Other", 1.0),
           (7, "Someone", "alb", "Other", 14.0)]
    matched = P.match_lfm_events_to_catalog(raw, tracks)
    assert matched == J.match_lfm_events_to_catalog(raw, tracks)
    assert P.generate_lfm_positives(matched) == [{"a": "id1", "b": "id2"}]


def _lfm_dir(tmp_path):
    (tmp_path / "LFM-1b_tracks.txt").write_text(
        "10\tSong One\t7\n11\tOther\t8\n")
    (tmp_path / "LFM-1b_artists.txt").write_text(
        "7\tThe Band\n8\tSomeone\n")
    (tmp_path / "LFM-1b_albums.txt").write_text("3\tAlb\t7\n")
    (tmp_path / "LFM-1b_LEs.txt").write_text(
        "1\t7\t3\t10\t100\n1\t8\t3\t11\t200\n1\t9\t3\t99\t300\n")
    return tmp_path


def test_lfm_id_resolution_chain_equal(tmp_path):
    lfm = _lfm_dir(tmp_path)
    tables = P.load_lfm_name_tables(str(lfm))
    assert tables == J.load_lfm_name_tables(str(lfm))
    rows = [r for c in P.iter_lfm_events(str(lfm / "LFM-1b_LEs.txt"))
            for r in c.tolist()]
    jrows = [r for c in J.iter_lfm_events(str(lfm / "LFM-1b_LEs.txt"))
             for r in c.tolist()]
    assert rows == jrows
    named = list(P.resolve_lfm_names(rows, tables))
    assert named == list(J.resolve_lfm_names(jrows, tables))
    assert named == [(1, "The Band", "Alb", "Song One", 100),
                     (1, "Someone", "Alb", "Other", 200)]
    tracks = {"id1": {"name": "Song One", "artist": "The Band"},
              "id2": {"name": "Other", "artist": "Someone"}}
    pairs = P.generate_lfm_positives(
        P.match_lfm_events_to_catalog(named, tracks))
    assert pairs == [{"a": "id1", "b": "id2"}]


TSV = {
    "ints": "1\t7\t3\t10\t100\n1\t8\t3\t11\t200\n",
    "bad_lines": "1\t7\t3\t10\t100\n1\t2\n4\t5\t6\t7\t8\t9\n2\t8\t3\t11\t5\n",
    "names": "10\tSong One\t7\n11\t\t8\n12\t1999\t9\n",
    "floats": "1\t0.5\n2\t\n3\t7\n",
}


# pandas' chunked reader keeps the first fields of a too-long line once
# its first chunk is read; the port skips such a line in every chunk, as
# pandas does for a file read in one chunk, so "bad_lines" runs unchunked
TSV_CASES = [(case, rows) for case in sorted(TSV) for rows in (1, 2, 1000)
             if case != "bad_lines" or rows == 1000]


@pytest.mark.parametrize("case,chunk_rows", TSV_CASES)
def test_tsv_chunks_equal_pandas(tmp_path, case, chunk_rows):
    path = tmp_path / "f.txt"
    path.write_text(TSV[case])
    want = [c.to_numpy() for c in pd.read_csv(
        path, sep="\t", header=None, chunksize=chunk_rows,
        on_bad_lines="skip")]
    got = list(P.iter_lfm_events(str(path), chunk_rows=chunk_rows))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert pd.DataFrame(g).equals(pd.DataFrame(w))


@pytest.mark.parametrize("sample_every,skip", [(2, 0), (1, 1), (2, 1)])
def test_iter_lfm_events_sampling_equal(tmp_path, sample_every, skip):
    path = tmp_path / "les.txt"
    path.write_text("".join(f"{i}\t1\t2\t3\t{i * 10}\n" for i in range(9)))
    kw = dict(chunk_rows=2, sample_every=sample_every, skip_chunks=skip)
    assert [c.tolist() for c in P.iter_lfm_events(str(path), **kw)] == \
        [c.tolist() for c in J.iter_lfm_events(str(path), **kw)]
