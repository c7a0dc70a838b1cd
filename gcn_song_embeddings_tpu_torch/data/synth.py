"""Synthetic datasets in the reference's on-disk format.

Own copy of gcn_song_embeddings_tpu/data/synth.py: numpy only, so the
same seed writes byte-identical files from either package.

``make_synthetic_dataset`` plants latent "genres" (playlists mostly hold
tracks of their own cluster, features are noisy cluster centroids,
positives link same-cluster tracks).  ``make_hard_dataset`` splits the
signal between the modalities so the graph must beat the features
(features reveal only a genre group, the graph reveals artists, positives
are mostly same-artist), with power-law playlist sizes and popularity;
at 200k tracks and more it streams its JSON.  ``make_synthetic_dataset_
large`` is the vectorized million-track generator, and
``ensure_hard_dataset`` creates or reuses a hard dataset behind a
provenance marker.
"""

from __future__ import annotations

import json
import os

import numpy as np


def make_synthetic_dataset(
    out_dir: str,
    n_tracks: int = 2000,
    n_collections: int = 400,
    n_clusters: int = 16,
    tracks_per_collection: int = 20,
    n_positives: int = 5000,
    feature_dim: int = 64,
    seed: int = 0,
    write_features: bool = True,
    cluster_purity: float = 0.85,
) -> str:
    """Write a synthetic dataset to `out_dir`; returns `out_dir`."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    track_ids = [f"t{i:06d}" for i in range(n_tracks)]
    col_ids = [f"c{i:06d}" for i in range(n_collections)]

    track_cluster = rng.integers(0, n_clusters, size=n_tracks)
    col_cluster = rng.integers(0, n_clusters, size=n_collections)

    # --- playlist membership: mostly own-cluster tracks -------------------
    cluster_members = [np.where(track_cluster == c)[0] for c in range(n_clusters)]
    edges: set[tuple[int, int]] = set()
    for ci in range(n_collections):
        own = cluster_members[col_cluster[ci]]
        for _ in range(tracks_per_collection):
            if own.size and rng.random() < cluster_purity:
                t = int(rng.choice(own))
            else:
                t = int(rng.integers(0, n_tracks))
            edges.add((t, ci))

    # Every track must appear in >=1 collection (walk kernels assume
    # degree >= 1, like the reference's randint over successors,
    # pinsage_model.py:41-46 which crashes on isolated nodes).
    covered = {t for t, _ in edges}
    for t in range(n_tracks):
        if t not in covered:
            own_cols = np.where(col_cluster == track_cluster[t])[0]
            ci = int(rng.choice(own_cols)) if own_cols.size else int(
                rng.integers(0, n_collections))
            edges.add((t, ci))

    # --- write tracks.json / collections.json ----------------------------
    tracks = {
        tid: {
            "name": f"Song {i}",
            "artist": f"Artist {track_cluster[i]}",
            "album": f"Album {i // 10}",
            "album_id": f"a{i // 10:06d}",
            "popularity": int(rng.integers(0, 100)),
            "preview_url": "",
        }
        for i, tid in enumerate(track_ids)
    }
    collections = {
        cid: {
            "type": "playlist",
            "name": f"Playlist {i}",
            "num_tracks": 0,
            "description": "",
            "ztracks": [],
        }
        for i, cid in enumerate(col_ids)
    }
    edge_list = []
    for t, c in sorted(edges):
        collections[col_ids[c]]["ztracks"].append(track_ids[t])
        # both directions materialized, like the scraper (get_data.py:211-214)
        edge_list.append({"from": track_ids[t], "to": col_ids[c]})
        edge_list.append({"from": col_ids[c], "to": track_ids[t]})
    for cid in col_ids:
        collections[cid]["num_tracks"] = len(collections[cid]["ztracks"])

    _dump(os.path.join(out_dir, "tracks.json"), tracks)
    _dump(os.path.join(out_dir, "collections.json"), collections)
    _dump(os.path.join(out_dir, "graph.json"),
          {"tracks": track_ids, "collections": col_ids, "edges": edge_list})

    # --- positives: same-cluster co-listens ------------------------------
    pos = []
    for _ in range(n_positives):
        c = int(rng.integers(0, n_clusters))
        members = cluster_members[c]
        if members.size < 2:
            continue
        a, b = rng.choice(members, size=2, replace=False)
        pos.append({"a": track_ids[int(a)], "b": track_ids[int(b)]})
    _dump(os.path.join(out_dir, "positives.json"), pos)

    # --- features: noisy cluster centroids -------------------------------
    if write_features:
        centroids = rng.normal(size=(n_clusters, feature_dim))
        feats = (centroids[track_cluster]
                 + 0.5 * rng.normal(size=(n_tracks, feature_dim)))
        np.save(os.path.join(out_dir, "features.npy"),
                feats.astype(np.float32))

    return out_dir


_STREAM_JSON_MIN = 200_000  # above this, make_hard_dataset streams JSON


def _dump(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)


def make_hard_dataset(
    out_dir: str,
    n_tracks: int = 20_000,
    tracks_per_artist: int = 20,
    artists_per_genre: int = 25,
    genres_per_group: int = 2,
    n_collections: int = 4_000,
    collection_size_range: tuple[int, int] = (5, 200),
    collection_size_alpha: float = 2.2,
    focus_artists: int = 6,
    p_secondary: float = 0.3,
    p_wild: float = 0.05,
    popularity_exponent: float = 0.8,
    p_artist_positive: float = 0.8,
    n_positives: int = 60_000,
    feature_dim: int = 128,
    feature_noise: float = 1.0,
    f_cold: float = 0.3,
    seed: int = 0,
) -> str:
    """Benchmark dataset where the graph signal must beat the feature signal.

    The uniform-cluster generator above saturates: its features are noisy
    cluster centroids, so raw-feature kNN sits at the ceiling and a GNN can
    only match it (round-1 VERDICT).  This generator plants a three-level
    latent hierarchy mirroring real music catalogs
    (reference eval on real co-listen data, eval.py:413-467):

      feature group  >  genre  >  artist  >  track

    and deliberately splits the signal between modalities:

    * **Features reveal only the group**: every genre in a group shares one
      feature centroid ("twin genres"), so content kNN cannot separate
      genres, let alone artists.  A further ``f_cold`` fraction of tracks
      gets noise-only features (tracks without audio clips — the
      reference's preview_url-missing case, get_data.py:455).
    * **The graph reveals artists**: each playlist focuses on a handful of
      artists of one genre (optionally mixing a sibling genre of the same
      group), so co-membership separates artists and genres.
    * **Positives are mostly same-artist co-listens** (``p_artist_positive``),
      the rest same-genre — so ranking well requires artist-level structure
      that only the graph carries.
    * **Power-law everything**: Pareto playlist sizes
      (``collection_size_alpha``) and Zipf track/artist popularity
      (``popularity_exponent``) give realistic skewed degree distributions,
      making the cold-start eval slices (low degree / low co-occurrence)
      meaningful.

    Track ids are randomly permuted so node id order carries no cluster
    locality (exercises gather locality honestly).  On-disk format is the
    reference's (SURVEY §7).  Returns ``out_dir``.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    if n_tracks % tracks_per_artist:
        raise ValueError("n_tracks must be a multiple of tracks_per_artist")
    n_artists = n_tracks // tracks_per_artist
    if n_artists % artists_per_genre:
        raise ValueError("n_tracks/tracks_per_artist must be a multiple of "
                         "artists_per_genre")
    n_genres = n_artists // artists_per_genre
    if n_genres % genres_per_group:
        raise ValueError("genre count must be a multiple of genres_per_group")

    # --- latent assignment: tracks -> artist -> genre -> group ------------
    # track_of[a, s] = track id of artist a's slot s; ids randomly permuted
    track_of = rng.permutation(n_tracks).reshape(n_artists, tracks_per_artist)
    artist = np.empty(n_tracks, dtype=np.int64)
    slot = np.empty(n_tracks, dtype=np.int64)
    artist[track_of] = np.arange(n_artists)[:, None]
    slot[track_of] = np.arange(tracks_per_artist)[None, :]
    genre = artist // artists_per_genre
    group = genre // genres_per_group

    # --- popularity: Zipf over artists x Zipf over within-artist slots ----
    artist_rank = rng.permutation(n_artists)
    w_artist = (1.0 + artist_rank) ** -popularity_exponent
    w_slot = (1.0 + np.arange(tracks_per_artist)) ** -popularity_exponent
    slot_cdf = np.cumsum(w_slot) / w_slot.sum()
    track_pop = w_artist[artist] * w_slot[slot]
    track_cdf = np.cumsum(track_pop) / track_pop.sum()

    # --- playlists: Pareto sizes, a few focus artists, sibling-genre mix --
    smin, smax = collection_size_range
    u = rng.random(n_collections)
    sizes = np.clip(smin * (1.0 - u) ** (-1.0 / (collection_size_alpha - 1.0)),
                    smin, smax).astype(np.int64)
    col_genre = rng.integers(0, n_genres, size=n_collections)
    sibling = (col_genre // genres_per_group) * genres_per_group + rng.integers(
        0, genres_per_group, size=n_collections)
    # focus artists: per slot, draw from the sibling genre w.p. p_secondary
    use_sib = rng.random((n_collections, focus_artists)) < p_secondary
    focus_g = np.where(use_sib, sibling[:, None], col_genre[:, None])
    focus_a = (focus_g * artists_per_genre
               + rng.integers(0, artists_per_genre,
                              size=(n_collections, focus_artists)))

    # per-membership sampling, fully vectorized over all edges
    col_of_edge = np.repeat(np.arange(n_collections), sizes)
    m = len(col_of_edge)
    e_focus = rng.integers(0, focus_artists, size=m)
    e_artist = focus_a[col_of_edge, e_focus]
    e_slot = np.searchsorted(slot_cdf, rng.random(m))
    e_track = track_of[e_artist, e_slot]
    wild = rng.random(m) < p_wild
    if wild.any():
        e_track = np.where(
            wild, np.searchsorted(track_cdf, rng.random(m)), e_track)

    # guarantee every track appears in >=1 playlist (walk kernels assume
    # degree >= 1, like the reference's randint over successors,
    # pinsage_model.py:41-46) — attach missing tracks to an own-genre
    # playlist (vectorized: genre-sorted column index + random offset into
    # the genre's block; at 1M tracks `missing` can be 10^5-scale)
    missing = np.setdiff1d(np.arange(n_tracks), np.unique(e_track))
    if missing.size:
        g_order = np.argsort(col_genre, kind="stable")
        g_starts = np.searchsorted(col_genre[g_order],
                                   np.arange(n_genres + 1))
        g_counts = np.diff(g_starts)
        mg = genre[missing]
        offs = (rng.random(missing.size)
                * np.maximum(g_counts[mg], 1)).astype(np.int64)
        extra_cols = g_order[np.minimum(g_starts[mg] + offs,
                                        n_collections - 1)]
        # genres with no playlist at all fall back to uniform
        empty = g_counts[mg] == 0
        if empty.any():
            extra_cols = np.where(
                empty, rng.integers(0, n_collections, size=missing.size),
                extra_cols)
        e_track = np.concatenate([e_track, missing])
        col_of_edge = np.concatenate([col_of_edge, extra_cols])

    # dedup (track, collection)
    enc = e_track.astype(np.int64) * n_collections + col_of_edge
    enc = np.unique(enc)
    t_e = enc // n_collections
    c_e = enc % n_collections

    # --- write the reference-format JSON files ----------------------------
    # cold tracks = no audio clip -> noise-only features, drawn once and
    # used consistently for preview_url and the feature matrix below
    cold = rng.random(n_tracks) < f_cold
    width = max(6, len(str(n_tracks - 1)))
    track_ids = [f"t{i:0{width}d}" for i in range(n_tracks)]
    col_ids = [f"c{i:0{width}d}" for i in range(n_collections)]
    by_col = np.argsort(c_e, kind="stable")
    c_sorted, t_sorted = c_e[by_col], t_e[by_col]
    col_starts = np.searchsorted(c_sorted, np.arange(n_collections + 1))
    pop99 = (99 * track_pop / track_pop.max()).astype(np.int64)

    if n_tracks >= _STREAM_JSON_MIN:
        # dataset_large shape (VERDICT r2 item 6): building per-edge dicts
        # allocates tens of millions of objects at 10^6 tracks — stream
        # the SAME reference-format JSON in bounded batches instead (the
        # multi-hundred-MB graph.json is what native/jsongraph.cc scans)
        with open(os.path.join(out_dir, "tracks.json"), "w",
                  encoding="utf-8") as f:
            f.write("{")
            f.write(",".join(
                f'"{track_ids[i]}":{{"name":"Song {i}",'
                f'"artist":"Artist {artist[i]}",'
                f'"artist_id":"ar{artist[i]:06d}",'
                f'"album":"Genre {genre[i]}","album_id":"g{genre[i]:06d}",'
                f'"popularity":{pop99[i]},'
                f'"preview_url":"{"" if cold[i] else f"clip{i}.mp3"}"}}'
                for i in range(n_tracks)))
            f.write("}")
        with open(os.path.join(out_dir, "collections.json"), "w",
                  encoding="utf-8") as f:
            f.write("{")
            parts = []
            for c in range(n_collections):
                members = t_sorted[col_starts[c]:col_starts[c + 1]]
                zt = ",".join(f'"{track_ids[t]}"' for t in members)
                parts.append(
                    f'"{col_ids[c]}":{{"type":"playlist",'
                    f'"name":"Playlist {c} (genre {col_genre[c]})",'
                    f'"num_tracks":{len(members)},"description":"",'
                    f'"ztracks":[{zt}]}}')
                if len(parts) >= 4096:
                    f.write(",".join(parts))
                    parts = [""]  # leading comma for the next batch
            f.write(",".join(parts))
            f.write("}")
        with open(os.path.join(out_dir, "graph.json"), "w",
                  encoding="utf-8") as f:
            f.write('{"tracks":[')
            f.write(",".join(f'"{t}"' for t in track_ids))
            f.write('],"collections":[')
            f.write(",".join(f'"{c}"' for c in col_ids))
            f.write('],"edges":[')
            step = 1 << 18
            for s in range(0, len(t_e), step):
                chunk = ",".join(
                    f'{{"from":"{track_ids[t]}","to":"{col_ids[c]}"}},'
                    f'{{"from":"{col_ids[c]}","to":"{track_ids[t]}"}}'
                    for t, c in zip(t_e[s:s + step], c_e[s:s + step]))
                f.write(chunk if s == 0 else "," + chunk)
            f.write("]}")
    else:
        tracks = {
            tid: {
                "name": f"Song {i}",
                "artist": f"Artist {artist[i]}",
                "artist_id": f"ar{artist[i]:06d}",
                "album": f"Genre {genre[i]}",
                "album_id": f"g{genre[i]:06d}",
                "popularity": int(pop99[i]),
                "preview_url": "" if cold[i] else f"clip{i}.mp3",
            }
            for i, tid in enumerate(track_ids)
        }
        collections = {}
        for c in range(n_collections):
            members = t_sorted[col_starts[c]:col_starts[c + 1]]
            collections[col_ids[c]] = {
                "type": "playlist",
                "name": f"Playlist {c} (genre {col_genre[c]})",
                "num_tracks": int(len(members)),
                "description": "",
                "ztracks": [track_ids[t] for t in members],
            }
        edge_list = []
        for t, c in zip(t_e, c_e):
            edge_list.append({"from": track_ids[t], "to": col_ids[c]})
            edge_list.append({"from": col_ids[c], "to": track_ids[t]})
        _dump(os.path.join(out_dir, "tracks.json"), tracks)
        _dump(os.path.join(out_dir, "collections.json"), collections)
        _dump(os.path.join(out_dir, "graph.json"),
              {"tracks": track_ids, "collections": col_ids,
               "edges": edge_list})

    # --- positives: popularity-weighted, same-artist else same-genre ------
    q = np.searchsorted(track_cdf, rng.random(n_positives))
    same_artist = rng.random(n_positives) < p_artist_positive
    p_slot = np.searchsorted(slot_cdf, rng.random(n_positives))
    pos_artist_same = track_of[artist[q], p_slot]
    # same-genre partner: random other artist of the query's genre
    other_a = (genre[q] * artists_per_genre
               + rng.integers(0, artists_per_genre, size=n_positives))
    pos_genre = track_of[other_a, np.searchsorted(
        slot_cdf, rng.random(n_positives))]
    p = np.where(same_artist, pos_artist_same, pos_genre)
    keep = p != q
    if n_tracks >= _STREAM_JSON_MIN:
        with open(os.path.join(out_dir, "positives.json"), "w",
                  encoding="utf-8") as f:
            f.write("[")
            f.write(",".join(
                f'{{"a":"{track_ids[int(x)]}","b":"{track_ids[int(y)]}"}}'
                for x, y in zip(q[keep], p[keep])))
            f.write("]")
    else:
        _dump(os.path.join(out_dir, "positives.json"),
              [{"a": track_ids[int(x)], "b": track_ids[int(y)]}
               for x, y in zip(q[keep], p[keep])])

    # --- features: group centroid (+ noise), cold tracks noise-only -------
    centroids = rng.standard_normal((n_genres // genres_per_group,
                                     feature_dim)).astype(np.float32)
    feats = centroids[group] + feature_noise * rng.standard_normal(
        (n_tracks, feature_dim)).astype(np.float32)
    feats[cold] = (np.sqrt(1.0 + feature_noise ** 2)
                   * rng.standard_normal((int(cold.sum()), feature_dim))
                   .astype(np.float32))
    np.save(os.path.join(out_dir, "features.npy"), feats)

    # latent ground truth for tests/analysis (not consumed by the pipeline)
    np.savez(os.path.join(out_dir, "latent.npz"),
             artist=artist, genre=genre, group=group, cold=cold,
             track_pop=track_pop, col_genre=col_genre)
    return out_dir


def make_synthetic_dataset_large(
    out_dir: str,
    n_tracks: int = 1_000_000,
    n_collections: int = 200_000,
    n_clusters: int = 2000,
    tracks_per_collection: int = 30,
    n_positives: int = 1_000_000,
    feature_dim: int = 512,
    seed: int = 0,
) -> str:
    """Vectorized dataset_large-scale generator (same on-disk format).

    The standard generator builds Python dicts per edge — fine to ~100k
    tracks, prohibitive at 10^6 (tens of millions of dict allocations).
    This path samples membership with numpy and writes graph.json in
    bounded batches (the resulting multi-hundred-MB file is what the
    native C++ scanner exists for).  Track metadata is minimal; features
    are f32 noisy centroids.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    track_cluster = rng.integers(0, n_clusters, size=n_tracks)
    col_cluster = rng.integers(0, n_clusters, size=n_collections)

    # membership: each collection picks tracks near its cluster by sampling
    # cluster-sorted track positions around the cluster's block
    order = np.argsort(track_cluster, kind="stable")
    cluster_starts = np.searchsorted(track_cluster[order],
                                     np.arange(n_clusters + 1))
    sizes = np.diff(cluster_starts)
    m = n_collections * tracks_per_collection
    col_of_edge = np.repeat(np.arange(n_collections, dtype=np.int64),
                            tracks_per_collection)
    cl = col_cluster[col_of_edge]
    offs = (rng.random(m) * np.maximum(sizes[cl], 1)).astype(np.int64)
    tracks_of_edge = order[np.minimum(cluster_starts[cl] + offs,
                                      n_tracks - 1)]
    # empty clusters (possible when clusters >> tracks/cluster) fall back
    # to uniform tracks, plus a uniform tail for cross-cluster edges
    wild = (rng.random(m) < 0.1) | (sizes[cl] == 0)
    tracks_of_edge = np.where(
        wild, rng.integers(0, n_tracks, size=m), tracks_of_edge)
    # guarantee every track appears at least once
    missing = np.setdiff1d(np.arange(n_tracks),
                           np.unique(tracks_of_edge))
    if missing.size:
        extra_cols = rng.integers(0, n_collections, size=missing.size)
        col_of_edge = np.concatenate([col_of_edge, extra_cols])
        tracks_of_edge = np.concatenate([tracks_of_edge, missing])
    # dedup (t, c)
    enc = tracks_of_edge.astype(np.int64) * n_collections + col_of_edge
    enc = np.unique(enc)
    t_e = (enc // n_collections).astype(np.int64)
    c_e = (enc % n_collections).astype(np.int64)

    # --- stream the JSON files -------------------------------------------
    with open(os.path.join(out_dir, "tracks.json"), "w",
              encoding="utf-8") as f:
        f.write("{")
        f.write(",".join(
            f'"t{i:07d}":{{"name":"Song {i}","artist":"Artist '
            f'{track_cluster[i]}"}}' for i in range(n_tracks)))
        f.write("}")
    by_col_order = np.argsort(c_e, kind="stable")
    c_sorted = c_e[by_col_order]
    t_sorted = t_e[by_col_order]
    col_starts = np.searchsorted(c_sorted, np.arange(n_collections + 1))
    with open(os.path.join(out_dir, "collections.json"), "w",
              encoding="utf-8") as f:
        f.write("{")
        parts = []
        for c in range(n_collections):
            members = t_sorted[col_starts[c]:col_starts[c + 1]]
            zt = ",".join(f'"t{t:07d}"' for t in members)
            parts.append(f'"c{c:07d}":{{"type":"playlist","name":"P{c}",'
                         f'"num_tracks":{len(members)},"ztracks":[{zt}]}}')
        f.write(",".join(parts))
        f.write("}")
    with open(os.path.join(out_dir, "graph.json"), "w",
              encoding="utf-8") as f:
        f.write('{"tracks":[')
        f.write(",".join(f'"t{i:07d}"' for i in range(n_tracks)))
        f.write('],"collections":[')
        f.write(",".join(f'"c{i:07d}"' for i in range(n_collections)))
        f.write('],"edges":[')
        # write in bounded batches: the full edge-string list for ~10^7
        # edges would hold GBs of Python strings in memory at once
        batch = 200_000
        for s0 in range(0, len(t_e), batch):
            chunk = ",".join(
                f'{{"from":"t{t:07d}","to":"c{c:07d}"}},'
                f'{{"from":"c{c:07d}","to":"t{t:07d}"}}'
                for t, c in zip(t_e[s0:s0 + batch], c_e[s0:s0 + batch]))
            if s0:
                f.write(",")
            f.write(chunk)
        f.write("]}")

    # positives: same-cluster pairs, vectorized
    pc = rng.integers(0, n_clusters, size=n_positives)
    ok = sizes[pc] >= 2
    pc = pc[ok]
    a_off = (rng.random(len(pc)) * sizes[pc]).astype(np.int64)
    b_off = (rng.random(len(pc)) * sizes[pc]).astype(np.int64)
    a = order[cluster_starts[pc] + a_off]
    b = order[cluster_starts[pc] + b_off]
    keep = a != b
    with open(os.path.join(out_dir, "positives.json"), "w",
              encoding="utf-8") as f:
        f.write("[")
        f.write(",".join(f'{{"a":"t{x:07d}","b":"t{y:07d}"}}'
                         for x, y in zip(a[keep], b[keep])))
        f.write("]")

    # standard_normal(dtype=f32) avoids a [n_tracks, d] float64 transient
    # (~4 GB at default scale) in the path that exists to bound memory
    centroids = rng.standard_normal((n_clusters, feature_dim),
                                    dtype=np.float32)
    feats = centroids[track_cluster]
    feats += 0.5 * rng.standard_normal((n_tracks, feature_dim),
                                       dtype=np.float32)
    np.save(os.path.join(out_dir, "features.npy"), feats)
    return out_dir


def ensure_hard_dataset(ds_path: str, n_tracks: int = 20_000,
                        n_collections: int = 4_000,
                        n_positives: int = 60_000, seed: int = 0,
                        log=print) -> str:
    """Create-or-reuse a hard-benchmark dataset with the provenance guard.

    A complete dataset already in `ds_path` must carry the 'hard'
    dataset_kind.txt marker (a missing marker means unknown provenance —
    refused), so a reused work dir can never be silently evaluated and
    published as hard-benchmark results (ADVICE r3).  The single guard
    implementation shared by every benchmark script."""
    import os

    marker = os.path.join(ds_path, "dataset_kind.txt")
    complete = all(os.path.isfile(os.path.join(ds_path, f)) for f in
                   ("graph.json", "positives.json", "features.npy"))
    if complete:
        prev = (open(marker).read().strip()
                if os.path.isfile(marker) else "unknown")
        if prev != "hard":
            raise RuntimeError(
                f"{ds_path} holds a {prev!r} dataset but a HARD-benchmark "
                f"dataset was requested; use a different work dir "
                f"(refusing to mislabel results)")
        log(f"reusing dataset in {ds_path}")
        return ds_path
    log("synthesizing hard dataset ...")
    make_hard_dataset(ds_path, n_tracks=n_tracks,
                      n_collections=n_collections,
                      n_positives=n_positives, seed=seed)
    with open(marker, "w") as f:
        f.write("hard")
    return ds_path
