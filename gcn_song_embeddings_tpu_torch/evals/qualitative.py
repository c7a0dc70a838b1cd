"""Qualitative exploration + recommendation-list export (own copy of
gcn_song_embeddings_tpu/evals/qualitative.py).

Reference eval.py:473-627: print kNN lists with song metadata, interactively
crawl the embedding space, export per-query recommendation lists as JSON +
album-cover images + a LaTeX comparison figure from examples_template.tex.
Host code on numpy arrays (kNN lists and embeddings from either package);
the files it writes equal the JAX package's byte for byte.  The PCA
behind ``plot_embedding_projection`` is ``pca_projection``; matplotlib is
imported only by the plot.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np


def examine_knn_weights(knn_dict, ranks=(0, 1, 2, 3, 10, 50, 100, 500)
                        ) -> None:
    """Print kNN weights at selected ranks (eval.py:473-479)."""
    for name in knn_dict:
        knn_w, _ = knn_dict[name]
        cols = [r for r in ranks if r < knn_w.shape[1]]
        print(f"{name}:\n{knn_w[0:10][:, cols]}")


def knn_example(emb: np.ndarray, n_examples: int, k: int, graph,
                seed: int = 0, print_fn=print) -> None:
    """Eyeball-check kNN of random queries by euclidean distance
    (reference knn_example / song_titles, pinsage_training.py:368-388)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_examples):
        q = int(rng.integers(0, emb.shape[0]))
        dist = np.linalg.norm(emb - emb[q], axis=1)
        nn = np.argsort(dist)[:k]
        titles = []
        for i in nn:
            info = graph.tracks[graph.track_ids[int(i)]]
            titles.append(f"{info.get('artist', '')} - {info['name']}")
        print_fn(" | ".join(titles))


def examine_emb(model_names, save_dir: str, print_fn=print) -> None:
    """Print the top-left corner of each model's cached embedding matrix
    (reference examine_emb, eval.py:481-486)."""
    from gcn_song_embeddings_tpu_torch.evals.harness import (
        load_embedding,
    )

    for name in model_names:
        emb = load_embedding(name, save_dir)
        print_fn(f"{name}:\n{emb[0:10, 0:10]}")


def export_recommendation_lists(graph, queries, knn_dict, model_names=None,
                                k: int = 5, out_root: str = "examples"
                                ) -> None:
    """Export lists + figure for several queries (reference
    export_recommendation_lists, eval.py:538-548)."""
    model_names = list(model_names or knn_dict)
    for q in queries:
        for name in model_names:
            _, knn_n = knn_dict[name]
            export_recommendation_list(graph, q, knn_n, name, k=k,
                                       out_root=out_root)
        export_recommendation_figure(graph, q, knn_dict, model_names,
                                     k=k - 1, out_root=out_root)


def pca_projection(emb: np.ndarray, sample: int = 2000, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(rows, coordinates [len(rows), 2]): ``sample`` rows drawn with
    ``default_rng(seed)``, centred and projected on their first two
    principal axes (SVD)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(emb.shape[0])[:sample]
    x = emb[idx] - emb[idx].mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return idx, x @ vt[:2].T


def plot_embedding_projection(emb: np.ndarray, out_path: str,
                              labels=None, sample: int = 2000,
                              seed: int = 0) -> str:
    """2-D PCA scatter of the embedding space (the reference's `plot_tsne`
    is an empty stub, eval.py:631-633; PCA keeps this dependency-light)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idx, proj = pca_projection(emb, sample, seed)
    plt.figure(figsize=(6, 6))
    if labels is None:
        plt.scatter(proj[:, 0], proj[:, 1], s=3, alpha=0.6)
    else:
        plt.scatter(proj[:, 0], proj[:, 1], s=3,
                    c=np.asarray(labels)[idx], cmap="tab20", alpha=0.6)
    plt.title(f"embedding PCA projection (n={len(idx)})")
    plt.tight_layout()
    plt.savefig(out_path, dpi=120)
    plt.close()
    return out_path


def format_knn(graph, in_degrees: np.ndarray, knn_w: np.ndarray,
               knn_n: np.ndarray) -> str:
    """Readable kNN list with name/artist/degree
    (reference print_knn, eval.py:492-505)."""
    lines = ["Nearest neighbors:"]
    for i in range(knn_n.shape[0]):
        node = int(knn_n[i])
        track = graph.tracks[graph.track_ids[node]]
        deg = int(in_degrees[node]) * 2  # in+out, both directions present
        lines.append(f"{i}. [{float(knn_w[i]):.3f}] {track['name']} - "
                     f"{track['artist']} ({deg})")
    return "\n".join(lines)


def format_query(q: int, graph) -> str:
    info = graph.tracks[graph.track_ids[int(q)]]
    return f"{info['name']}\n{info['artist']}"


def crawl_embedding(knn_dict, graph, model_names=None, K: int = 10,
                    seed: int = 0, input_fn=input, print_fn=print) -> None:
    """Interactive crawl: show each model's top-K for random queries;
    'e' exports the current lists, 'q' quits (reference crawl_embedding,
    eval.py:512-535)."""
    model_names = list(model_names or knn_dict)
    rng = np.random.default_rng(seed)
    deg = graph.in_degrees()
    q = int(rng.integers(0, graph.n_items))
    while True:
        print_fn(format_query(q, graph))
        for i, name in enumerate(model_names):
            knn_w, knn_n = knn_dict[name]
            print_fn(f"[{i}]{name}:")
            print_fn(format_knn(graph, deg, knn_w[q, :K], knn_n[q, :K]))
        choice = input_fn("Select neighbor rank to crawl into, e to "
                          "export, q to quit, r for random: ")
        if choice == "q":
            return
        if choice == "e":
            for name in model_names:
                _, knn_n = knn_dict[name]
                export_recommendation_list(graph, q, knn_n, name)
            export_recommendation_figure(graph, q, knn_dict, model_names)
            continue
        if choice.isdigit() and int(choice) < K:
            # crawl into the selected neighbor (first model's list)
            _, knn_n = knn_dict[model_names[0]]
            q = int(knn_n[q, int(choice)])
            continue
        q = int(rng.integers(0, graph.n_items))


def export_recommendation_list(graph, q: int, knn_n: np.ndarray,
                               model_name: str, k: int = 5,
                               out_root: str = "examples") -> str:
    """Export query + top-k as examples/<song>/<model>/list.json with
    album covers (reference export_recommendation_list, eval.py:551-572)."""
    q = int(q)
    rec_list = [q] + [int(x) for x in knn_n[q, :k]]
    q_name = _safe_name(graph.tracks[graph.track_ids[q]]["name"])
    dir_name = os.path.join(out_root, q_name, model_name)
    os.makedirs(dir_name, exist_ok=True)
    info_list = []
    for rank, tr in enumerate(rec_list):
        info = graph.tracks[graph.track_ids[tr]]
        info_list.append({"title": info["name"],
                          "artist": info.get("artist", ""),
                          "album": info.get("album", "")})
        _copy_track_image(graph.base_dir, dir_name, info, rank)
    with open(os.path.join(dir_name, "list.json"), "w",
              encoding="utf-8") as f:
        json.dump(info_list, f, indent=2)
    return dir_name


def export_recommendation_figure(graph, q: int, knn_dict, model_names,
                                 k: int = 4, out_root: str = "examples",
                                 template_path: Optional[str] = None) -> str:
    """Fill a LaTeX comparison-figure template with per-model rec lists
    (reference export_recommendation_figure, eval.py:588-627).
    Placeholders: <method_M>, <cover_M_I>, <title_M_I>, <artist_M_I>,
    <album_M_I>."""
    template = (open(template_path, encoding="utf-8").read()
                if template_path else _default_template(len(model_names),
                                                        k + 1))
    q = int(q)
    q_name = _safe_name(graph.tracks[graph.track_ids[q]]["name"])
    dir_name = os.path.join(out_root, q_name)
    os.makedirs(os.path.join(dir_name, "covers"), exist_ok=True)

    for m, name in enumerate(model_names):
        _, knn_n = knn_dict[name]
        rec_list = [q] + [int(x) for x in knn_n[q, :k]]
        template = template.replace(f"<method_{m}>", name)
        for i, tr in enumerate(rec_list):
            info = graph.tracks[graph.track_ids[tr]]
            fname = _copy_track_image(graph.base_dir,
                                      os.path.join(dir_name, "covers"),
                                      info, i)
            # path RELATIVE to figure.tex's own directory so the figure
            # compiles from there (not only from the process cwd)
            cover = (os.path.join("covers", fname) if fname
                     else os.path.join(
                         "covers", f"{i:02d}_"
                         f"{_safe_name(info['name'])}.jpg"))
            template = template.replace(f"<cover_{m}_{i}>", cover)
            template = template.replace(f"<title_{m}_{i}>", info["name"])
            template = template.replace(f"<artist_{m}_{i}>",
                                        info.get("artist", ""))
            template = template.replace(f"<album_{m}_{i}>",
                                        info.get("album", ""))
    fig_path = os.path.join(dir_name, "figure.tex")
    with open(fig_path, "w", encoding="utf-8") as f:
        f.write(template)
    return fig_path


def _safe_name(name: str) -> str:
    return re.sub(r"[/\\]", "", name)


def _copy_track_image(dataset_dir: str, save_dir: str, track_info: dict,
                      rank: int) -> Optional[str]:
    """Copy the album cover if present (reference export_track_image,
    eval.py:576-585; images are optional here).  The rank prefixes the
    filename so same-titled tracks in one list don't overwrite each
    other's covers.  Returns the written filename, or None."""
    album_id = track_info.get("album_id")
    if not album_id:
        return None
    src = os.path.join(dataset_dir, "images", album_id + ".jpg")
    if not os.path.isfile(src):
        return None
    os.makedirs(save_dir, exist_ok=True)
    fname = f"{rank:02d}_{_safe_name(track_info['name'])}.jpg"
    shutil.copy(src, os.path.join(save_dir, fname))
    return fname


def _default_template(n_models: int, n_items: int) -> str:
    """Minimal LaTeX grid template with the reference's placeholder
    scheme (examples_template.tex equivalent)."""
    rows = []
    for m in range(n_models):
        cells = [f"<method_{m}>"]
        for i in range(n_items):
            cells.append(
                f"\\begin{{tabular}}{{c}}<title_{m}_{i}>\\\\"
                f"\\scriptsize <artist_{m}_{i}>\\\\"
                f"\\tiny <album_{m}_{i}>\\end{{tabular}}")
        rows.append(" & ".join(cells) + r" \\")
    cols = "l" + "c" * n_items
    return ("\\begin{figure}\n\\begin{tabular}{" + cols + "}\n"
            + "\n".join(rows) + "\n\\end{tabular}\n\\end{figure}\n")
