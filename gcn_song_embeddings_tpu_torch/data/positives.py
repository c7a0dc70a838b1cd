"""Positive-pair generation (reference generate_positives.py and
generate_positives_lfm.py): a numpy copy of the JAX package's
``data/positives.py``, bit-equal to it.

Three generators, each emitting the reference JSON format
``[{"a": track_id, "b": track_id}, ...]``:

  * PPR-walk positives: a random track paired with a random neighbor of
    rank < 3 in the precomputed neighborhood cache
    (generate_positives.py:13-45).
  * Random positives (generate_positives.py:58-75).
  * LFM listening-event positives: stream an LFM-1b listening log, resolve
    its ids through the sidecar tables, join (lowercased name, artist) to
    the catalog and pair ADJACENT same-user listens closer than
    ``max_delta_t`` (the reference's inverted filter applied as its
    comment intends)::

        iter_lfm_events(LFM-1b_LEs.txt)
        -> resolve_lfm_names(rows, load_lfm_name_tables(lfm_dir))
        -> match_lfm_events_to_catalog(named_rows, tracks)
        -> generate_lfm_positives(matched)

The LFM files are tab-separated and read with the ``csv`` module (pandas
is not on the card's machine), typed per column as pandas' reader types
them: integers, else floats (an empty field is NaN), else strings.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Iterable, Iterator, Optional

import numpy as np


def generate_walk_positives(nbhds: tuple[np.ndarray, np.ndarray],
                            n_tracks: int, m: Optional[int] = None,
                            max_rank: int = 3, seed: int = 0,
                            out_path: Optional[str] = None) -> list[dict]:
    """``m`` pairs (track, random PPR neighbor of rank < max_rank), ``m``
    5x the track count by default; pairs whose neighbor slot is empty
    (weight 0) are dropped."""
    weights, nodes = nbhds
    m = m if m is not None else 5 * n_tracks
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_tracks, size=m)
    rank = rng.integers(0, max_rank, size=m)
    b = nodes[a, rank]
    valid = weights[a, rank] > 0
    pairs = [(int(x), int(y)) for x, y, v in zip(a, b, valid) if v]
    return _emit(pairs, out_path)


def generate_random_positives(n_tracks: int, m: int, seed: int = 0,
                              out_path: Optional[str] = None) -> list[dict]:
    """Uniform random pairs, self-pairs dropped."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_tracks, size=m)
    b = rng.integers(0, n_tracks, size=m)
    pairs = [(int(x), int(y)) for x, y in zip(a, b) if x != y]
    return _emit(pairs, out_path)


def _emit(pairs: list[tuple], out_path: Optional[str]) -> list[dict]:
    out = [{"a": a, "b": b} for a, b in pairs]
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(out, f)
    return out


def indices_to_id_pairs(pairs: list[dict], track_ids: list[str]
                        ) -> list[dict]:
    """Integer-index pairs -> string-id pairs (the reference stores ids)."""
    return [{"a": track_ids[p["a"]], "b": track_ids[p["b"]]} for p in pairs]


# ------------------------------------------------------------------ LFM path


def lfm_track_key(name: str, artist: str, album: Optional[str] = None
                  ) -> tuple:
    """Lowercased join key (generate_positives_lfm.py:67-103)."""
    key = (name.strip().lower(), artist.strip().lower())
    if album is not None:
        key = key + (album.strip().lower(),)
    return key


def build_catalog_map(tracks: dict, use_album: bool = False
                      ) -> dict[tuple, str]:
    """{(name, artist[, album]): track_id} from a tracks.json dict; the
    first track of a key wins."""
    out: dict[tuple, str] = {}
    for tid, info in tracks.items():
        key = lfm_track_key(info.get("name", ""), info.get("artist", ""),
                            info.get("album") if use_album else None)
        out.setdefault(key, tid)
    return out


def _typed(column: list[str]) -> tuple[list, str]:
    """One column typed as pandas' reader types it: integers ("i"), else
    floats with empty fields NaN ("f"), else strings with empty fields NaN
    ("O")."""
    try:
        return [int(v) for v in column], "i"
    except ValueError:
        pass
    try:
        return [float(v) if v != "" else float("nan") for v in column], "f"
    except ValueError:
        return [v if v != "" else float("nan") for v in column], "O"


def _as_array(rows: list[list[str]], width: int) -> np.ndarray:
    """Rows -> one array, as ``DataFrame.to_numpy`` gives it: int64 if
    every column is integer, float64 if every column is numeric, else
    object."""
    cols, kinds = zip(*(_typed([r[j] if j < len(r) else "" for r in rows])
                        for j in range(width)))
    dtype = (np.int64 if set(kinds) == {"i"}
             else np.float64 if set(kinds) <= {"i", "f"} else object)
    out = np.empty((len(rows), width), dtype=dtype)
    for j, c in enumerate(cols):
        out[:, j] = c
    return out


def _tsv_chunks(path: str, chunk_rows: int) -> Iterator[np.ndarray]:
    """[rows, width] arrays of a header-less TSV, ``chunk_rows`` rows at a
    time; the width is the first line's, longer lines are skipped and
    shorter ones padded with NaN (pandas' ``on_bad_lines="skip"``)."""
    with open(path, newline="", encoding="utf-8") as f:
        width = None
        rows: list[list[str]] = []
        for row in csv.reader(f, delimiter="\t"):
            if not row:
                continue
            width = width or len(row)
            if len(row) > width:
                continue
            rows.append(row)
            if len(rows) == chunk_rows:
                yield _as_array(rows, width)
                rows = []
        if rows:
            yield _as_array(rows, width)


def iter_lfm_events(path: str, chunk_rows: int = 1_000_000,
                    sample_every: int = 1, skip_chunks: int = 0
                    ) -> Iterable[np.ndarray]:
    """Stream an LFM-1b listening-events TSV (user_id, artist_id,
    album_id, track_id, timestamp) in chunks of ``chunk_rows``, keeping
    every ``sample_every``-th chunk after the first ``skip_chunks``."""
    for i, chunk in enumerate(_tsv_chunks(path, chunk_rows)):
        if i < skip_chunks or (i - skip_chunks) % sample_every:
            continue
        yield chunk


def _name_table(path: str) -> dict:
    """{id: name} of a sidecar TSV whose first two columns are id, name."""
    out: dict = {}
    for chunk in _tsv_chunks(path, 1_000_000):
        out.update(zip(chunk[:, 0].tolist(), chunk[:, 1].tolist()))
    return out


def load_lfm_name_tables(lfm_dir: str) -> tuple[dict, dict, dict]:
    """id -> name maps from LFM-1b_tracks.txt / _artists.txt /
    _albums.txt: (track_names, artist_names, album_names)."""
    return tuple(_name_table(os.path.join(lfm_dir, f"LFM-1b_{kind}.txt"))
                 for kind in ("tracks", "artists", "albums"))


def resolve_lfm_names(raw_rows: Iterable,
                      name_tables: tuple[dict, dict, dict]
                      ) -> Iterable[tuple]:
    """Id-coded rows (user_id, artist_id, album_id, track_id, timestamp)
    -> name-coded rows (user_id, artist_name, album_name, track_name,
    timestamp); events whose track or artist id is unknown are dropped,
    an unknown album becomes ""."""
    track_names, artist_names, album_names = name_tables
    for row in raw_rows:
        tn = track_names.get(row[3])
        an = artist_names.get(row[1])
        if tn is None or an is None:
            continue
        yield (row[0], an, album_names.get(row[2], ""), tn, row[4])


def generate_lfm_positives(events: Iterable[tuple[int, str, float]],
                           max_delta_t: float = 3600.0,
                           out_path: Optional[str] = None) -> list[dict]:
    """Pairs of consecutive listens per user: ``events`` yields (user_id,
    track_id, timestamp) already matched to the catalog; adjacent
    same-user events pair when 0 <= dt <= max_delta_t and the tracks
    differ."""
    pairs: list[tuple[str, str]] = []
    last_by_user: dict = {}
    for user, track, ts in events:
        prev = last_by_user.get(user)
        if prev is not None:
            prev_track, prev_ts = prev
            dt = ts - prev_ts
            if prev_track != track and 0 <= dt <= max_delta_t:
                pairs.append((prev_track, track))
        last_by_user[user] = (track, ts)
    return _emit(pairs, out_path)


def match_lfm_events_to_catalog(raw_events: Iterable, tracks: dict,
                                name_col: int = 3, artist_col: int = 1,
                                user_col: int = 0, ts_col: int = 4
                                ) -> list[tuple[int, str, float]]:
    """Join (user, artist name, ..., track name, ts) rows to the catalog
    by lowercased (name, artist), sorted by (user, ts)."""
    catalog = build_catalog_map(tracks)
    out = []
    for row in raw_events:
        tid = catalog.get(lfm_track_key(str(row[name_col]),
                                        str(row[artist_col])))
        if tid is not None:
            out.append((int(row[user_col]), tid, float(row[ts_col])))
    out.sort(key=lambda r: (r[0], r[2]))
    return out
