"""PinSage trainer on one device: triple sampling, one [3B] forward,
max-margin loss, Adam with per-epoch staircase decay, chunked checkpoints.

Mirrors the JAX package's ``train/trainer.py``.  A chunk of
``checkpoint_every_batches`` batches may span epochs (the learning rate
is indexed by the Adam count, not by the epoch loop); each chunk draws
its batches from a generator seeded from (``train.seed`` + 1, global
batch index at the chunk's start), and a checkpoint is written at every
chunk's end, so a resumed run replays a continuous one.  Metrics come
back to the host once per chunk and are appended to
``<run_dir>/metrics.jsonl`` under the JAX package's field names.

On the GPU the step's frontier forward aggregates with kernel K3 and the
full-graph forward with K2; both carry gradients through
``ops.agg.ConvAggregate``.

``train.dtype="bfloat16"`` or ``"float16"`` trains in mixed precision,
as the JAX package does: the master weights and Adam's state stay f32,
the step reads a 16-bit copy of the feature table and 16-bit casts of
the weights (their gradients flow back through the cast, rounded to
16 bits), and every product accumulates in f32 (``models.pinsage``; the
16-bit forms of K3 and K2 on the GPU).  ``"float64"`` trains in f32
after one warning, as the JAX package does (``jnp.dtype`` truncates it:
x64 is never enabled).  ``embed`` and the checkpoints read the f32 table
and the f32 master weights whatever the dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.config import (
    PinSageConfig,
    RunConfig,
    TrainConfig,
)
from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    apply_colisten_config,
)
from gcn_song_embeddings_tpu_torch.models.pinsage import (
    PinSageParams,
    cast_params,
    embed_all,
    forward_with_gather,
    fullgraph_embeddings,
    fullgraph_wins,
    head_apply,
    init_pinsage,
    pack_nbhds,
    packed_nbhd_gather,
    pinsage_forward,
)
from gcn_song_embeddings_tpu_torch.ops.ppr import (
    block_generator,
    precompute_neighborhoods,
)
from gcn_song_embeddings_tpu_torch.train.adam import Adam
from gcn_song_embeddings_tpu_torch.train.loss import (
    batch_variance,
    cosine_triplet_loss,
    max_margin_loss,
)
from gcn_song_embeddings_tpu_torch.train.sampler import sample_batch
from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
    load_state,
    save_state,
)

BASE_RUN_DIR = "./runs"
# per-batch metrics, in the order of train_step's output
METRICS = ("Train Loss", "Node Features Loss", "Batch Variance",
           "Learning Rate", "Gradient Norm")
# train.dtype (by numpy's name for it, "half" as "float16") -> the step's
# compute type; float64 as the JAX package trains it without x64
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float32}


def make_optimizer(params: PinSageParams, tcfg: TrainConfig) -> Adam:
    """Adam over ``params.leaves()`` with rate ``lr * decay ** (count //
    batches_per_epoch)``."""
    return Adam([p for _, p in params.leaves()], tcfg.lr, tcfg.decay,
                tcfg.batches_per_epoch)


class TrainTables(NamedTuple):
    """The step's device tables: features [N, in] f32, top-T neighborhood
    weights and nodes [N, >=T], their packed [N, 2T] form, and the
    features in the step's dtype (``features`` itself under f32, a 16-bit
    copy under bf16 or f16; ``embed`` reads ``features``)."""
    features: torch.Tensor
    nbhd_w: torch.Tensor
    nbhd_n: torch.Tensor
    packed: torch.Tensor
    step_features: torch.Tensor

    @staticmethod
    def build(features, nbhd_w, nbhd_n, T: int,
              device: str | torch.device = "cpu",
              dtype: str = "float32") -> "TrainTables":
        f = torch.as_tensor(features, dtype=torch.float32, device=device)
        w = torch.as_tensor(nbhd_w, dtype=torch.float32, device=device)
        n = torch.as_tensor(nbhd_n, dtype=torch.int32, device=device)
        return TrainTables(f, w, n, pack_nbhds(w, n, T),
                           f.to(step_dtype(dtype)))


def dtype_name(dtype: str) -> str:
    """``train.dtype`` as the JAX trainer's ``jnp.dtype(tcfg.dtype)``
    reads it: "bfloat16", or numpy's name of the type ("half" is
    "float16", "double" "float64"); a name neither knows raises."""
    if dtype == "bfloat16":
        return dtype
    try:
        return np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"train.dtype={dtype!r} names no type") from None


def step_dtype(dtype: str) -> torch.dtype:
    """``train.dtype`` -> the step's compute type: the float types the
    JAX trainer trains in, "float64" as f32 (``DTYPES``); any other type
    raises."""
    name = dtype_name(dtype)
    if name not in DTYPES:
        raise ValueError(f"train.dtype={dtype!r}: the port trains in "
                         f"{', '.join(DTYPES)}")
    return DTYPES[name]


def use_fullgraph(tcfg: TrainConfig, mcfg: PinSageConfig,
                  n_items: int) -> bool:
    """``train.fullgraph_forward``: "on", "off", or "auto" (the full-graph
    forward when the triple batch's frontier outgrows the catalog)."""
    if tcfg.fullgraph_forward not in ("auto", "on", "off"):
        raise ValueError(f"train.fullgraph_forward must be auto|on|off, got "
                         f"{tcfg.fullgraph_forward!r}")
    return (tcfg.fullgraph_forward == "on"
            or (tcfg.fullgraph_forward == "auto"
                and fullgraph_wins(3 * tcfg.batch_size, n_items,
                                   mcfg.n_layers, mcfg.T)))


def triple_loss(params: PinSageParams, tables: TrainTables,
                batch: torch.Tensor, tcfg: TrainConfig, mcfg: PinSageConfig,
                fullgraph: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-margin loss of a [B, 3] batch through one [3B] forward in the
    step's dtype (that of ``tables.step_features``); returns (loss,
    h_q)."""
    nodes = torch.cat([batch[:, 0], batch[:, 1], batch[:, 2]])
    feats = tables.step_features
    if feats.dtype != torch.float32:
        params = cast_params(params, feats.dtype)
    if fullgraph:
        h_all = fullgraph_embeddings(
            params, feats, tables.nbhd_w.to(feats.dtype), tables.nbhd_n,
            mcfg.n_layers, mcfg.T)
        emb = head_apply(params, h_all[nodes.long()])
    else:
        emb = forward_with_gather(
            params, lambda ids: feats[ids.long()],
            packed_nbhd_gather(tables.packed, mcfg.T), nodes, mcfg.n_layers,
            mcfg.T)
    h_q, h_pos, h_neg = emb.chunk(3)
    return max_margin_loss(h_q, h_pos, h_neg, tcfg.margin), h_q


def train_step(params: PinSageParams, opt: Adam, batch: torch.Tensor,
               tables: TrainTables, tcfg: TrainConfig, mcfg: PinSageConfig,
               fullgraph: bool) -> torch.Tensor:
    """One Adam step on ``batch`` [B, 3], params updated in place.
    Returns the step's metrics [5] (``METRICS`` order) on the device,
    without waiting for it."""
    rate = opt.rate()
    loss, h_q = triple_loss(params, tables, batch, tcfg, mcfg, fullgraph)
    grads = torch.autograd.grad(loss, opt.params)
    grad_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    opt.step(grads)
    with torch.no_grad():
        f_rows = tables.step_features[batch.reshape(-1).long()].float()
        f_rows = f_rows.reshape(batch.shape[0], 3, -1)
        f_rows = f_rows / torch.clamp(torch.linalg.vector_norm(
            f_rows, dim=-1, keepdim=True), min=1e-12)
        node_feat_loss = cosine_triplet_loss(f_rows[:, 0], f_rows[:, 1],
                                             f_rows[:, 2])
        return torch.stack([loss.detach(), node_feat_loss,
                            batch_variance(h_q.detach()),
                            loss.new_tensor(rate), grad_norm])


def sample_train_batch(gen: torch.Generator, positives: torch.Tensor,
                       tables: TrainTables, tcfg: TrainConfig, n_items: int,
                       count: int) -> torch.Tensor:
    """The next [B, 3] batch from ``gen`` after ``count`` steps; with the
    hard-negative curriculum, hard negatives from epoch
    ``hn_start_epoch`` on."""
    hn_gate = None
    if tcfg.hard_negatives and tcfg.hn_start_epoch > 0:
        hn_gate = count >= tcfg.hn_start_epoch * tcfg.batches_per_epoch
    return sample_batch(gen, positives, tables.nbhd_n, tcfg.batch_size,
                        n_items, hard_negatives=tcfg.hard_negatives,
                        hn_min=tcfg.hn_min, hn_max=tcfg.hn_max,
                        exact=tcfg.exact_batch_sampling, hn_gate=hn_gate)


def train_chunk(params: PinSageParams, opt: Adam, tables: TrainTables,
                positives: torch.Tensor, gen: torch.Generator,
                tcfg: TrainConfig, mcfg: PinSageConfig, n_items: int,
                n_chunk: int, fullgraph: bool) -> torch.Tensor:
    """``n_chunk`` Adam steps, each on a batch drawn from ``gen`` (the JAX
    package's ``_train_chunk``); returns their metrics [n_chunk, 5] on
    the device, without waiting for them."""
    return torch.stack([
        train_step(params, opt, sample_train_batch(
            gen, positives, tables, tcfg, n_items, opt.count),
            tables, tcfg, mcfg, fullgraph)
        for _ in range(n_chunk)])


class PinSageTrainer:
    """Construct with graph + features + positives (resuming from
    ``<run_dir>/state.npz`` when ``load_save``), then ``train()`` and
    ``embed()``.  Runs on the graph's device."""

    def __init__(self, graph: DeviceGraph, n_items: int,
                 features: np.ndarray, positives: np.ndarray,
                 cfg: Optional[RunConfig] = None,
                 base_run_dir: str = BASE_RUN_DIR,
                 nbhds_path: Optional[str] = None,
                 nbhds: Optional[tuple[np.ndarray, np.ndarray]] = None,
                 log: bool = True, load_save: bool = True,
                 verbose: bool = True):
        cfg = cfg if cfg is not None else RunConfig()
        if cfg.model.in_dim != features.shape[1]:
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, in_dim=features.shape[1]))
        self.cfg = cfg
        tcfg, mcfg = cfg.train, cfg.model
        step_dtype(tcfg.dtype)
        if dtype_name(tcfg.dtype) == "float64":
            warnings.warn("train.dtype='float64': float64 is not enabled "
                          "(as in the JAX package without x64); training "
                          "in float32", stacklevel=2)
        if tcfg.hard_negatives and tcfg.hn_max > cfg.walk.t_precompute:
            raise ValueError(
                f"train.hn_max={tcfg.hn_max} exceeds walk.t_precompute="
                f"{cfg.walk.t_precompute}: hard negatives are drawn from "
                f"the precomputed neighborhood ranks")
        self.n = n_items
        self.verbose = verbose
        self.device = graph.device
        self.fullgraph = use_fullgraph(tcfg, mcfg, n_items)
        graph, nbhds_path = apply_colisten_config(graph, positives, cfg.walk,
                                                  nbhds_path)
        self.graph = graph
        if nbhds is None:
            nbhds = precompute_neighborhoods(graph, cfg.walk, nbhds_path,
                                             seed=tcfg.seed, verbose=verbose)
        self.tables = TrainTables.build(features, nbhds[0], nbhds[1],
                                        mcfg.T, self.device, tcfg.dtype)
        self.positives = torch.as_tensor(positives, dtype=torch.int32,
                                         device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(tcfg.seed)
        self.params = init_pinsage(gen, mcfg.n_layers, features.shape[1],
                                   mcfg.hidden_dim, mcfg.out_dim,
                                   mcfg.bias_init)
        self.opt = make_optimizer(self.params, tcfg)

        self.e = 0          # epochs done
        self.b = 0          # batches done within the current epoch
        self.run_dir = os.path.join(base_run_dir, cfg.run_name)
        os.makedirs(self.run_dir, exist_ok=True)
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        self.log = log
        self._metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self.load_save = load_save
        if load_save:
            self.load_model()

    @property
    def state_path(self) -> str:
        return os.path.join(self.run_dir, "state.npz")

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        """The next [B, 3] batch from ``gen``; with the hard-negative
        curriculum, hard negatives from epoch ``hn_start_epoch`` on."""
        return sample_train_batch(gen, self.positives, self.tables,
                                  self.cfg.train, self.n, self.opt.count)

    def train(self) -> None:
        tcfg = self.cfg.train
        bpe = tcfg.batches_per_epoch
        total = tcfg.epochs * bpe
        chunk = min(tcfg.checkpoint_every_batches, total)
        done = self.e * bpe + self.b
        while done < total:
            t0 = time.time()
            n_chunk = min(chunk, total - done)
            gen = block_generator(tcfg.seed + 1, done, self.device)
            metrics = train_chunk(
                self.params, self.opt, self.tables, self.positives, gen,
                tcfg, self.cfg.model, self.n, n_chunk,
                self.fullgraph).cpu().numpy()
            if self.log:
                self._log_metrics(metrics, done)
            done += n_chunk
            self.e, self.b = divmod(done, bpe)
            if self.load_save:
                self.save_model()
            if self.verbose:
                print(f"epoch {self.e}/{tcfg.epochs} (batch {self.b}): "
                      f"{n_chunk} batches in {time.time() - t0:.2f}s, "
                      f"last loss={metrics[-1, 0]:.6f}")

    def embed(self, ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Embed ``ids`` (all items when None) -> numpy [len, out_dim]."""
        mcfg, t = self.cfg.model, self.tables
        if ids is None:
            out = embed_all(self.params, t.features, t.nbhd_w, t.nbhd_n,
                            self.n, mcfg.n_layers, mcfg.T)
        else:
            nodeset = torch.as_tensor(np.asarray(ids, dtype=np.int32),
                                      device=self.device)
            with torch.inference_mode():
                out = pinsage_forward(self.params, t.features, t.nbhd_w,
                                      t.nbhd_n, nodeset, mcfg.n_layers,
                                      mcfg.T)
        return out.cpu().numpy()

    def save_embeddings(self, path: Optional[str] = None) -> str:
        """Embed all items into one [N, out_dim] ``emb.npy``."""
        path = path or os.path.join(self.run_dir, "emb.npy")
        np.save(path, self.embed())
        return path

    def save_embeddings_per_track(self, track_ids: list[str],
                                  emb_dir: Optional[str] = None,
                                  fmt: str = "npy") -> str:
        """The reference's layout (pinsage_training.py:297-327): one
        vector file per track id under ``<run>/emb/``, ``<tid>.npy`` or,
        with ``fmt="pt"``, ``<tid>.pt`` through ``torch.save``; existing
        files are kept.  Returns the directory."""
        if fmt not in ("npy", "pt"):
            raise ValueError(f"fmt {fmt!r}: 'npy' or 'pt'")
        emb_dir = emb_dir or os.path.join(self.run_dir, "emb")
        os.makedirs(emb_dir, exist_ok=True)
        emb = self.embed()
        for i, tid in enumerate(track_ids):
            out = os.path.join(emb_dir, f"{tid}.{fmt}")
            if os.path.isfile(out):
                continue
            if fmt == "pt":
                torch.save(torch.from_numpy(np.array(emb[i])), out)
            else:
                np.save(out, emb[i])
        return emb_dir

    def save_model(self) -> None:
        save_state(self.state_path, self.params, self.opt,
                   {"epochs_done": self.e, "batches_done": self.b})

    def load_model(self) -> bool:
        if not os.path.isfile(self.state_path):
            return False
        scalars = load_state(self.state_path, self.params, self.opt)
        self.e = int(scalars["epochs_done"])
        self.b = int(scalars["batches_done"])
        # a checkpoint written at an epoch's end may carry
        # b == batches_per_epoch with the rollover not yet recorded
        if self.b >= self.cfg.train.batches_per_epoch:
            self.b = 0
            self.e += 1
        if self.verbose:
            print(f"resumed from {self.state_path} "
                  f"(epoch {self.e}, batch {self.b})")
        return True

    def _log_metrics(self, metrics: np.ndarray, done_before: int) -> None:
        bpe = self.cfg.train.batches_per_epoch
        with open(self._metrics_path, "a") as f:
            for i, row in enumerate(metrics):
                rec = {name: float(v) for name, v in zip(METRICS, row)}
                rec["epoch"] = (done_before + i) // bpe
                f.write(json.dumps(rec) + "\n")
