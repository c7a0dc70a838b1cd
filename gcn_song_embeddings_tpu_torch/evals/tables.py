"""Results tables, without pandas (own copy of
gcn_song_embeddings_tpu/evals/tables.py, which builds DataFrames).

A ``Table`` holds one row of floats per model under the JAX package's
column names, in its order.  ``to_csv`` writes what ``DataFrame.to_csv``
writes for it (a header with an empty index column, then one line per
model), so either package's CSV reads the same; ``to_string`` prints it
rounded to 5 places.
"""

from __future__ import annotations

import csv

import numpy as np

from gcn_song_embeddings_tpu_torch.evals import metrics as M


class Table:
    """Rows keyed by model name: ``rows[model][column] -> float``."""

    def __init__(self, rows: dict[str, dict[str, float]]):
        self.rows = rows
        self.columns: list[str] = []
        for row in rows.values():
            self.columns += [c for c in row if c not in self.columns]

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            out = csv.writer(f, lineterminator="\n")
            out.writerow(["", *self.columns])
            for model, row in self.rows.items():
                out.writerow([model, *(_cell(row[c]) if c in row else ""
                                       for c in self.columns)])

    def to_string(self) -> str:
        cells = [["", *self.columns]] + [
            [model, *(f"{round(row[c], 5):g}" if c in row else "NaN"
                      for c in self.columns)]
            for model, row in self.rows.items()]
        widths = [max(len(r[i]) for r in cells) for i in range(len(cells[0]))]
        return "\n".join(
            "  ".join([r[0].ljust(widths[0])]
                      + [x.rjust(w) for x, w in zip(r[1:], widths[1:])])
            for r in cells)


def _cell(value) -> str:
    """A value as ``DataFrame.to_csv`` writes it: the shortest text that
    reads back as the same float of its own width (f32 or f64)."""
    if isinstance(value, np.floating):
        return str(value)
    return repr(float(value))


def compute_results_table(knn_dict, test_positives: np.ndarray,
                          in_degrees: np.ndarray, times: bool = True,
                          degree_thr: int = 1) -> Table:
    """Accuracy table: hr@{10,100,500}, mrr@1000, low-degree / low-co
    mrr, and the train/emb/knn times where the dict keeps them."""
    results = {}
    for model in knn_dict:
        _, knn_mat = knn_dict[model]
        row = {f"hr (k={k})": M.hit_rate(knn_mat, test_positives, k)
               for k in (10, 100, 500)}
        row["mrr"] = M.mrr(knn_mat, test_positives, 1000)
        row["low-degree accuracy"] = M.low_degree_accuracy(
            knn_mat, in_degrees, test_positives, 1000, degree_thr, M.mrr)
        row["low-co accuracy"] = M.low_co_accuracy(
            knn_mat, test_positives, 1000, 1, M.mrr)
        if times and hasattr(knn_dict, "get_times"):
            row["t (train)"], row["t (emb)"], row["t (knn)"] = (
                knn_dict.get_times(model))
        results[model] = row
    return Table(results)


def compute_beyond_accuracy_table(knn_dict, test_positives: np.ndarray,
                                  in_degrees: np.ndarray,
                                  features: np.ndarray,
                                  device=None) -> Table:
    """Beyond-accuracy table at k=100: intra/inter diversity, coverage,
    average degree; ``intra_diversity`` runs on ``device`` when given."""
    k = 100
    results = {}
    for model in knn_dict:
        _, knn_mat = knn_dict[model]
        results[model] = {
            "intra diversity": M.intra_diversity(
                knn_mat, test_positives, k, features, device=device),
            "inter diversity": M.inter_diversity(knn_mat, test_positives, k),
            "coverage": M.coverage(knn_mat, test_positives, K=100),
            "average degree": M.average_degree(knn_mat, in_degrees,
                                               test_positives, k),
        }
    return Table(results)
