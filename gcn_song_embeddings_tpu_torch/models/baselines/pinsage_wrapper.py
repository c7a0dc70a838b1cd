"""PinSage as a baseline (own copy of
gcn_song_embeddings_tpu/models/baselines/pinsage_wrapper.py): the port's
``PinSageTrainer`` behind the ``EmbeddingModel`` interface, on
``device`` (default: the GPU, where training runs kernels K3 and K2).

Hyperparameters are a dotted-path dict (``{"train.epochs": 10,
"model.T": 5}``) over ``RunConfig``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
from gcn_song_embeddings_tpu_torch.models.baselines.base import (
    EmbeddingModel,
)
from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


class PinSageWrapper(EmbeddingModel):
    def __init__(self, train_params: Optional[dict[str, Any]] = None,
                 run_name: Optional[str] = None, log: bool = True,
                 base_run_dir: str = "temp_runs",
                 nbhds: Optional[tuple[np.ndarray, np.ndarray]] = None,
                 device=None):
        self.train_params = train_params or {}
        self.run_name = run_name or time.strftime("%X_%x").replace("/", "-")
        self.log = log
        self.base_run_dir = base_run_dir
        self.embedding: np.ndarray | None = None
        self._nbhds = nbhds
        self.device = device

    def train(self, graph, ids, train_set, test_set, features) -> None:
        from gcn_song_embeddings_tpu_torch.train.trainer import (
            PinSageTrainer,
        )

        dev = resolve_device(self.device)
        cfg = config_with_overrides(RunConfig(run_name=self.run_name),
                                    self.train_params)
        trainer = PinSageTrainer(
            DeviceGraph.from_graph(graph, dev), len(ids),
            np.asarray(features), np.asarray(train_set), cfg=cfg,
            base_run_dir=self.base_run_dir,
            nbhds_path=getattr(graph, "nbhds_path", None),
            nbhds=self._nbhds, log=self.log, load_save=False,
            verbose=False)
        trainer.train()
        emb_path = os.path.join(self.base_run_dir, self.run_name, "emb.npy")
        trainer.save_embeddings(emb_path)
        self.embedding = np.load(emb_path)
        self._table = torch.as_tensor(self.embedding, device=dev)
        self.trainer = trainer

    def embed(self, nodeset):
        return self.embedding[np.asarray(nodeset)]

    def knn(self, nodeset, k):
        return knn_from_emb(self._table, np.asarray(nodeset), k)
