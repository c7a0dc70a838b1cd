"""Recommender interfaces (own copy of
gcn_song_embeddings_tpu/models/baselines/base.py).

``train(graph, ids, train_set, test_set, features)`` then ``knn(nodeset,
k)`` -> (weights [n, k], nodes [n, k]); ``EmbeddingModel`` adds
``embed(nodeset)``.  The graph argument is the port's ``SongGraph``;
models that compute on a device build a ``DeviceGraph`` from it.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class PredictionModel(ABC):
    """Base recommender."""

    @abstractmethod
    def train(self, graph, ids, train_set, test_set, features) -> None:
        """Fit on the graph + train positives; test_set is passed for the
        reference's signature and must not be trained on."""

    @abstractmethod
    def knn(self, nodeset: np.ndarray, k: int
            ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k recommendations for each query: (weights, nodes)."""


class EmbeddingModel(PredictionModel):
    """A recommender backed by node embeddings."""

    @abstractmethod
    def embed(self, nodeset: np.ndarray) -> np.ndarray:
        """Return embedding rows for ``nodeset``."""
