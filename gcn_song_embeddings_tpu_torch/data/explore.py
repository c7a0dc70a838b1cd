"""Dataset exploration + curation tools (own copy of
gcn_song_embeddings_tpu/data/explore.py).

Reference dataset_creation/view_data.py: the PPR crawl with
degree-normalized visit counts, giant-component filtering and
mini-dataset subsampling; plus spotify_graph.py:197-214's distribution
CSV export, written without pandas.  The graph algorithms are
dependency-free (union-find instead of networkx).  The crawl walks with
``ops.walk_kernel.random_walks`` (kernel K1 on the GPU); its scoring,
``crawl_scores``, takes any trace.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

CRAWL_ALPHA = 0.85


# -------------------------------------------------------------- components


def giant_component(graph) -> np.ndarray:
    """Node ids (tracks + collections, global indexing) of the largest
    connected component (reference to_nx_graph + giant-component filter,
    view_data.py:365-385).  Union-find over the bipartite edges."""
    n = graph.n_nodes
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    i2c = graph.i2c
    for t in range(graph.n_items):
        for c in i2c.indices[i2c.indptr[t]:i2c.indptr[t + 1]]:
            rt, rc = find(t), find(int(c) + graph.n_items)
            if rt != rc:
                parent[rc] = rt
    roots = np.fromiter((find(i) for i in range(n)), dtype=np.int64, count=n)
    vals, counts = np.unique(roots, return_counts=True)
    big = vals[counts.argmax()]
    return np.where(roots == big)[0]


def make_mini_dataset(graph, out_dir: str, min_degree: int = 10,
                      max_degree: int = 15000,
                      features: np.ndarray | None = None) -> str:
    """Subsample a dataset: drop tracks outside [min_degree, max_degree],
    keep the giant component, rewrite all artifacts in the reference format
    (reference make_mini_dataset, view_data.py:295-330, degree cuts
    min 10 / max 15000).  The files equal the JAX package's byte for
    byte (same set and edge orders)."""
    deg = graph.i2c.degrees()
    keep_tracks = set(np.where((deg >= min_degree)
                               & (deg <= max_degree))[0].tolist())

    # rebuild edge list restricted to kept tracks
    i2c = graph.i2c
    edges = [(t, int(c)) for t in keep_tracks
             for c in i2c.indices[i2c.indptr[t]:i2c.indptr[t + 1]]]
    keep_cols = sorted({c for _, c in edges})

    # giant component on the reduced bipartite graph (union-find)
    tr_list = sorted(keep_tracks)
    tr_pos = {t: i for i, t in enumerate(tr_list)}
    col_pos = {c: len(tr_list) + i for i, c in enumerate(keep_cols)}
    parent = np.arange(len(tr_list) + len(keep_cols), dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for t, c in edges:
        a, b = find(tr_pos[t]), find(col_pos[c])
        if a != b:
            parent[b] = a
    roots = np.fromiter((find(i) for i in range(len(parent))),
                        dtype=np.int64)
    vals, counts = np.unique(roots, return_counts=True)
    big = vals[counts.argmax()]
    keep_tracks = [t for t in tr_list if roots[tr_pos[t]] == big]
    keep_cols = [c for c in keep_cols if roots[col_pos[c]] == big]
    kt, kc = set(keep_tracks), set(keep_cols)

    os.makedirs(out_dir, exist_ok=True)
    tracks = {graph.track_ids[t]: graph.tracks[graph.track_ids[t]]
              for t in keep_tracks}
    cols = {graph.col_ids[c]: graph.collections[graph.col_ids[c]]
            for c in keep_cols}
    edge_list = []
    for t, c in edges:
        if t in kt and c in kc:
            a, b = graph.track_ids[t], graph.col_ids[c]
            edge_list.append({"from": a, "to": b})
            edge_list.append({"from": b, "to": a})
    with open(os.path.join(out_dir, "tracks.json"), "w",
              encoding="utf-8") as f:
        json.dump(tracks, f)
    with open(os.path.join(out_dir, "collections.json"), "w",
              encoding="utf-8") as f:
        json.dump(cols, f)
    with open(os.path.join(out_dir, "graph.json"), "w",
              encoding="utf-8") as f:
        json.dump({"tracks": list(tracks), "collections": list(cols),
                   "edges": edge_list}, f)
    if features is not None:
        np.save(os.path.join(out_dir, "features.npy"),
                features[np.array(keep_tracks)])
    return out_dir


# ------------------------------------------------------------ distributions


def _levels_csv(path: str, levels: np.ndarray, counts: np.ndarray) -> None:
    """What ``pd.DataFrame((levels, counts)).to_csv(path)`` writes: a
    header of column numbers under an empty index cell, then the levels
    row (index 0) and the counts row (index 1), in the two arrays' common
    type (a float level makes every cell a float)."""
    table = np.stack([levels, counts])
    cell = repr if table.dtype.kind == "f" else str
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["", *range(table.shape[1])])
        for i, row in enumerate(table.tolist()):
            out.writerow([i, *map(cell, row)])


def save_dataset_distributions(graph, positives: np.ndarray,
                               out_dir: str = ".") -> list[str]:
    """Degree / co-occurrence distribution CSVs (reference
    save_dataset_distributions, spotify_graph.py:197-214), byte-equal to
    the JAX package's pandas output."""
    deg = graph.in_degrees()
    track_deg = deg[:graph.n_items]
    co = np.bincount(positives[:, 0], minlength=graph.n_items)

    outputs = {
        "pos_deg_repeats.csv": deg[positives.reshape(-1)],
        "pos_deg.csv": deg[np.unique(positives)],
        "graph_deg.csv": track_deg,
        "pos_co.csv": co[positives.reshape(-1)],
        "graph_co.csv": co,
    }
    paths = []
    for name, values in outputs.items():
        levels, counts = np.unique(values, return_counts=True)
        path = os.path.join(out_dir, name)
        _levels_csv(path, levels, counts)
        paths.append(path)
    return paths


# ------------------------------------------------------------------- crawl


def crawl_schedule(graph, start: int, num_steps: int | None = None
                   ) -> tuple[int, int]:
    """(walkers, hops) of the crawl from ``start``: ``num_steps`` defaults
    to 200 * deg^(2/3), at least 200 (view_data.py:35-65), spread over at
    most 256 walkers."""
    deg = int(graph.i2c.degrees()[start])
    if num_steps is None:
        num_steps = max(int(200 * deg ** (2 / 3)), 200)
    walkers = min(num_steps, 256)
    return walkers, max(num_steps // walkers, 1)


def crawl_scores(graph, trace: np.ndarray, start: int, top: int = 10
                 ) -> list[tuple[int, float]]:
    """The crawl's ranking from a walk trace (any shape of item ids):
    visit counts, the start's zeroed, scaled by 1/log(deg + 2); the
    ``top`` best with a positive score (reference count_walks_weighted,
    view_data.py:35-65)."""
    counts = np.bincount(np.asarray(trace).reshape(-1),
                         minlength=graph.n_items)
    counts[start] = 0
    all_deg = graph.i2c.degrees().astype(np.float64)
    scores = counts / np.log(all_deg + 2.0)
    order = np.argsort(-scores)[:top]
    return [(int(i), float(scores[i])) for i in order if scores[i] > 0]


def crawl_walk_counts(graph, start: int, num_steps: int | None = None,
                      seed: int = 0, top: int = 10, device=None
                      ) -> list[tuple[int, float]]:
    """Degree-normalized PPR crawl scores from ``start``: restart walks
    (alpha 0.85) of ``crawl_schedule``'s shape, drawn from a generator
    seeded with ``seed`` and walked by ``random_walks`` (K1 on the GPU),
    scored by ``crawl_scores``.  Runs on ``device`` (default: the GPU)."""
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.ops.walk_kernel import random_walks
    from gcn_song_embeddings_tpu_torch.ops.walks import fused_walk_tables

    dev = resolve_device(device)
    walkers, hops = crawl_schedule(graph, start, num_steps)
    tables = fused_walk_tables(DeviceGraph.from_graph(graph, dev))
    nodeset = torch.full((walkers,), start, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    trace = random_walks(tables, nodeset, hops, CRAWL_ALPHA, gen)
    return crawl_scores(graph, trace.cpu().numpy(), start, top)
