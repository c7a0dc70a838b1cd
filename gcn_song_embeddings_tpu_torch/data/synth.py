"""Synthetic dataset generator in the reference's on-disk format.

Own copy of ``make_synthetic_dataset`` from gcn_song_embeddings_tpu/
data/synth.py: the same seed writes the same files.  Tracks and
playlists each get a latent cluster, playlists mostly contain tracks of
their own cluster, features are noisy cluster centroids, and positives
link same-cluster tracks.
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

    # playlist membership: mostly own-cluster tracks
    cluster_members = [np.where(track_cluster == c)[0]
                       for c in range(n_clusters)]
    edges: set[tuple[int, int]] = set()
    for ci in range(n_collections):
        own = cluster_members[col_cluster[ci]]
        for _ in range(tracks_per_collection):
            if own.size and rng.random() < cluster_purity:
                t = int(rng.choice(own))
            else:
                t = int(rng.integers(0, n_tracks))
            edges.add((t, ci))

    # every track must appear in >= 1 collection (the walk assumes
    # degree >= 1)
    covered = {t for t, _ in edges}
    for t in range(n_tracks):
        if t not in covered:
            own_cols = np.where(col_cluster == track_cluster[t])[0]
            ci = int(rng.choice(own_cols)) if own_cols.size else int(
                rng.integers(0, n_collections))
            edges.add((t, ci))

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
        # both directions materialized, like the reference's scraper
        edge_list.append({"from": track_ids[t], "to": col_ids[c]})
        edge_list.append({"from": col_ids[c], "to": track_ids[t]})
    for cid in col_ids:
        collections[cid]["num_tracks"] = len(collections[cid]["ztracks"])

    _dump(os.path.join(out_dir, "tracks.json"), tracks)
    _dump(os.path.join(out_dir, "collections.json"), collections)
    _dump(os.path.join(out_dir, "graph.json"),
          {"tracks": track_ids, "collections": col_ids, "edges": edge_list})

    # positives: same-cluster co-listens
    pos = []
    for _ in range(n_positives):
        c = int(rng.integers(0, n_clusters))
        members = cluster_members[c]
        if members.size < 2:
            continue
        a, b = rng.choice(members, size=2, replace=False)
        pos.append({"a": track_ids[int(a)], "b": track_ids[int(b)]})
    _dump(os.path.join(out_dir, "positives.json"), pos)

    # features: noisy cluster centroids
    if write_features:
        centroids = rng.normal(size=(n_clusters, feature_dim))
        feats = (centroids[track_cluster]
                 + 0.5 * rng.normal(size=(n_tracks, feature_dim)))
        np.save(os.path.join(out_dir, "features.npy"),
                feats.astype(np.float32))

    return out_dir


def _dump(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)
