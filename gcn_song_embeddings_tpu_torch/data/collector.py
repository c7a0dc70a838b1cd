"""Dataset collection (own copy of gcn_song_embeddings_tpu/data/
collector.py): the reference's Spotify-scraper capability as an
offline-safe, source-pluggable collector.

Reference dataset_creation/get_data.py (`DatasetCollector`): random-query
playlist/album search against the Spotify API (1 album per 3 playlists,
<=50 tracks each, preview-url filter), bidirectional edge materialization,
incremental JSON persistence with backup/restore, clip & album-image
download with retry, genre/album backfill.  The Spotify preview-clip API the
reference relied on is retired (SURVEY #34: "treat as data format spec") and
a collector must run offline, so the collector here:

  * implements the same incremental on-disk protocol — tracks.json /
    collections.json / graph.json with both edge directions, backup files,
    resume-on-restart — against an abstract `CatalogSource`;
  * ships an offline `SyntheticSource` so the full collection path is
    exercisable end-to-end;
  * documents the exact JSON schema (SURVEY §7) for anyone plugging in a
    real API client.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import string
from abc import ABC, abstractmethod
from typing import Optional


class CatalogSource(ABC):
    """Abstract music-catalog API (the role spotipy plays in the
    reference)."""

    @abstractmethod
    def search_collections(self, query: str, limit: int,
                           col_type: str) -> list[dict]:
        """Return collection dicts: {id, type, name, num_tracks,
        description|artist, tracks: [track dicts]}.  Track dicts carry the
        SURVEY §7 fields (id, name, artist, album_id, preview_url, ...)."""


class SyntheticSource(CatalogSource):
    """Deterministic fake catalog for offline runs and tests."""

    def __init__(self, seed: int = 0, n_universe: int = 5000):
        self.rng = random.Random(seed)
        self.n_universe = n_universe

    def _track(self, i: int) -> dict:
        return {
            "id": f"syn{i:06d}",
            "name": f"Synthetic Song {i}",
            "artist": f"Artist {i % 97}",
            "artist_id": f"ar{i % 97:04d}",
            "album": f"Album {i // 10}",
            "album_id": f"al{i // 10:05d}",
            "popularity": self.rng.randint(0, 100),
            "preview_url": f"https://example.invalid/clip/{i}.mp3",
            "image_url": f"https://example.invalid/img/{i // 10}.jpg",
        }

    def search_collections(self, query, limit, col_type):
        out = []
        for _ in range(limit):
            cid = f"col{self.rng.randrange(10**9):09d}"
            n = self.rng.randint(5, 50)
            tracks = [self._track(self.rng.randrange(self.n_universe))
                      for _ in range(n)]
            out.append({
                "id": cid,
                "type": col_type,
                "name": f"{col_type} {query} {cid[-4:]}",
                "num_tracks": n,
                "description": "",
                "tracks": tracks,
            })
        return out


def random_query(rng: random.Random) -> str:
    """Random 1-2 letter search query (reference random_query,
    get_data.py:437-442 uses random letters to sample the catalog)."""
    k = rng.choice([1, 2])
    return "".join(rng.choice(string.ascii_lowercase) for _ in range(k))


class DatasetCollector:
    """Incremental dataset builder with the reference's persistence
    protocol (get_data.py:78-123: load-if-present, backup before save,
    atomic-ish rewrite; :211-214: bidirectional edges)."""

    def __init__(self, save_dir: str, source: Optional[CatalogSource] = None,
                 directed: bool = False, require_preview_url: bool = True,
                 seed: int = 0):
        self.save_dir = save_dir
        self.source = source or SyntheticSource(seed=seed)
        self.directed = directed
        self.require_preview_url = require_preview_url
        self.rng = random.Random(seed)
        os.makedirs(save_dir, exist_ok=True)
        self.track_dict: dict = self._load("tracks.json")
        self.col_dict: dict = self._load("collections.json")
        graph = self._load("graph.json")
        self.edges: list[dict] = graph.get("edges", []) if graph else []

    # ------------------------------------------------------------ persist

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    def _load(self, name: str):
        """Load with .bak restore: a crash mid-save leaves a corrupt JSON
        on disk; the backup is the valid prior state (reference restore
        protocol, get_data.py:92-121).  A dataset where BOTH copies exist
        but neither parses is an error — silently restarting empty would
        overwrite a recoverable dataset."""
        p = self._path(name)
        candidates = [c for c in (p, p + ".bak") if os.path.isfile(c)]
        for candidate in candidates:
            try:
                with open(candidate, encoding="utf-8") as f:
                    return json.load(f)
            except json.JSONDecodeError:
                continue
        if candidates:
            raise ValueError(
                f"{p} and its .bak are both unreadable JSON — refusing "
                f"to restart with an empty dataset; repair or remove them")
        return {}

    def _save(self) -> None:
        """Backup then write ATOMICALLY (reference get_data.py:92-121).

        The new content goes to a temp file first and is os.replace()d
        over the primary, so the primary is never truncated mid-write;
        the .bak (previous good state) is only refreshed from a primary
        that existed before this save, never clobbered by a corrupt one
        (see _load)."""
        for name, obj in (
                ("tracks.json", self.track_dict),
                ("collections.json", self.col_dict),
                ("graph.json", {"tracks": list(self.track_dict),
                                "collections": list(self.col_dict),
                                "edges": self.edges})):
            p = self._path(name)
            if os.path.isfile(p):
                shutil.copy(p, p + ".bak")
            tmp = p + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(obj, f)
            os.replace(tmp, p)

    # ------------------------------------------------------------ collect

    def collect(self, n_batches: int = 10, playlists_per_batch: int = 3,
                albums_per_batch: int = 1, max_tracks: int = 50) -> dict:
        """Random-query collection sweep (reference get_data.py:437-455:
        1 album per 3 playlists, <=50 tracks each, broad-except per
        iteration so one failure never kills the run)."""
        added = {"collections": 0, "tracks": 0}
        for _ in range(n_batches):
            try:
                q = random_query(self.rng)
                cols = (self.source.search_collections(
                            q, playlists_per_batch, "playlist")
                        + self.source.search_collections(
                            q, albums_per_batch, "album"))
                for col in cols:
                    if col["id"] in self.col_dict:
                        continue
                    tracks = col.pop("tracks")[:max_tracks]
                    if self.require_preview_url:
                        tracks = [t for t in tracks if t.get("preview_url")]
                    if not tracks:
                        continue
                    col["ztracks"] = [t["id"] for t in tracks]
                    col["num_tracks"] = len(tracks)
                    self.col_dict[col["id"]] = col
                    added["collections"] += 1
                    for t in tracks:
                        if t["id"] not in self.track_dict:
                            self.track_dict[t["id"]] = {
                                k: v for k, v in t.items() if k != "id"}
                            added["tracks"] += 1
                        self.edges.append({"from": t["id"],
                                           "to": col["id"]})
                        if not self.directed:
                            self.edges.append({"from": col["id"],
                                               "to": t["id"]})
                self._save()
            except Exception as e:  # broad like the reference scraper loop
                print(f"collection batch failed: {e!r}")
        return added

    # ------------------------------------------- media + metadata sweeps

    def download_clips(self, fetcher, retries: int = 3,
                       subdir: str = "clips", ext: str = ".mp3") -> dict:
        """Incremental preview-clip download with retry + orphan cleanup
        (reference get_data.py:240-287: skip-if-present, 3 attempts per
        clip, delete files whose track left the dataset).

        `fetcher(track_id, preview_url) -> bytes` abstracts the HTTP layer
        (tests plug a synthetic fetcher).
        """
        return self._media_sweep(
            subdir, ext, retries,
            items=((tid, info.get("preview_url"))
                   for tid, info in self.track_dict.items()
                   if info.get("preview_url")),
            fetch=fetcher,
            # orphans are media whose OWNER left the dataset — a track
            # whose preview_url merely went empty keeps its clip
            owners=set(self.track_dict))

    def download_images(self, fetcher, retries: int = 3,
                        subdir: str = "images", ext: str = ".jpg") -> dict:
        """Album-cover download keyed by album_id with retry + orphan
        cleanup (reference get_data.py:289-326)."""
        albums = {}
        owners = set()
        for info in self.track_dict.values():
            aid = info.get("album_id")
            if not aid:
                continue
            owners.add(aid)
            if info.get("image_url"):
                albums.setdefault(aid, info["image_url"])
        return self._media_sweep(subdir, ext, retries,
                                 items=albums.items(), fetch=fetcher,
                                 owners=owners)

    def _media_sweep(self, subdir: str, ext: str, retries: int, items,
                     fetch, owners: set) -> dict:
        out_dir = os.path.join(self.save_dir, subdir)
        os.makedirs(out_dir, exist_ok=True)
        stats = {"downloaded": 0, "skipped": 0, "failed": 0, "orphans": 0}
        for key, url in items:
            path = os.path.join(out_dir, key + ext)
            if os.path.isfile(path):
                stats["skipped"] += 1
                continue
            for attempt in range(retries):
                try:
                    data = fetch(key, url)
                    with open(path, "wb") as f:
                        f.write(data)
                    stats["downloaded"] += 1
                    break
                except Exception as e:
                    if attempt == retries - 1:
                        print(f"media fetch failed for {key}: {e!r}")
                        stats["failed"] += 1
        # orphan cleanup: media whose owner left the dataset
        for fname in os.listdir(out_dir):
            if fname.endswith(ext) and fname[: -len(ext)] not in owners:
                os.remove(os.path.join(out_dir, fname))
                stats["orphans"] += 1
        return stats

    def backfill_metadata(self, lookup, fields=("album", "release_date",
                                                "artist_genres")) -> int:
        """Fill missing per-track metadata fields via
        `lookup(track_id) -> dict` (reference genre/album backfill,
        get_data.py:365-417).  Returns the number of tracks updated."""
        updated = 0
        for tid, info in self.track_dict.items():
            missing = [f for f in fields if not info.get(f)]
            if not missing:
                continue
            try:
                extra = lookup(tid) or {}
            except Exception as e:
                print(f"backfill failed for {tid}: {e!r}")
                continue
            changed = False
            for f in missing:
                if extra.get(f):
                    info[f] = extra[f]
                    changed = True
            updated += changed
        if updated:
            self._save()
        return updated

    def track_image_map(self, subdir: str = "images",
                        ext: str = ".jpg") -> dict:
        """{track_id: album-image path} for tracks whose cover exists on
        disk (reference get_track_image_mapping, get_data.py:421-435)."""
        out_dir = os.path.join(self.save_dir, subdir)
        out = {}
        for tid, info in self.track_dict.items():
            aid = info.get("album_id")
            if not aid:
                continue
            path = os.path.join(out_dir, aid + ext)
            if os.path.isfile(path):
                out[tid] = path
        return out
