"""Sharded training over a (dp, graph) mesh of ranks
(gcn_song_embeddings_tpu/parallel/train_step.py on ``torch.distributed``).

  * ``dp``: the triple batch is split over the ranks; every rank
    computes B / (dp * g) triples.
  * ``graph``: node tables (features, packed neighborhoods, and with hard
    negatives the flattened neighborhood nodes) are row-sharded over the
    dp row's ``graph`` group; frontier lookups are collective gathers
    (``parallel/gather.py``).
  * Parameters and Adam state are replicated (rank 0's initial
    parameters are broadcast).  Each rank's loss is its batch mean over
    the number of ranks; loss and gradients are summed over the world in
    one ``all_reduce`` of a flat buffer, so every rank applies the
    global-batch gradient.  (Not DDP: DDP averages, and hooks one
    reduction per bucket into a step that is already bound by launches.)

On the GPU the frontier forward aggregates with K3 and the full-graph
forward (``train.fullgraph_forward="on"``: each graph shard convolves its
own rows with collectively gathered neighbor rows) with K2; the gradient
of the gathered activations flows back through the gather's transpose.

Randomness is an input: ``step`` takes the rank's batch, and
``train_chunk(batches=...)`` a list of them.  Without it, batch i of a
chunk starting at global batch ``b0`` is drawn from a generator shared by
every rank (seeded from (train.seed + 1, b0); with
``exact_batch_sampling`` every rank draws the same global permutation
and takes its block) or from the rank's own (seeded from (train.seed +
1, b0, rank)).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gcn_song_embeddings_tpu_torch.config import RunConfig
from gcn_song_embeddings_tpu_torch.models.pinsage import (
    PinSageParams,
    conv_apply,
    forward_with_gather,
    fullgraph_wins,
    head_apply,
    init_pinsage,
    pack_nbhds_np,
    unpack_nbhd_rows,
)
from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator
from gcn_song_embeddings_tpu_torch.parallel import collectives as C
from gcn_song_embeddings_tpu_torch.parallel.gather import gather_fn
from gcn_song_embeddings_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
from gcn_song_embeddings_tpu_torch.train.loss import max_margin_loss
from gcn_song_embeddings_tpu_torch.train.sampler import (
    sample_easy_negatives,
    sample_positive_rows,
)
from gcn_song_embeddings_tpu_torch.train.trainer import make_optimizer
from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
    load_state,
    save_state,
)


def _check_hard_negative_extent(n_pad: int, width: int) -> None:
    """The hard-negative gather indexes the flattened neighborhood table
    as node * width + rank in int32; past 2^31 entries that wraps."""
    if n_pad * width >= np.iinfo(np.int32).max:
        raise ValueError(
            f"hard-negative table extent {n_pad} x {width} = "
            f"{n_pad * width} overflows the int32 flattened index; shrink "
            f"t_precompute or disable hard_negatives at this catalog size")


class ShardedTrainer:
    """PinSage training over a (dp, graph) mesh; every rank of the world
    constructs one with the same arguments and calls the same methods in
    the same order.  ``params`` (default: ``init_pinsage`` seeded with
    ``train.seed``) is copied, and rank 0's copy broadcast."""

    def __init__(self, mesh: Mesh, cfg: RunConfig, n_items: int,
                 features: np.ndarray, nbhds: tuple[np.ndarray, np.ndarray],
                 positives: np.ndarray, gather_impl: str = "psum_scatter",
                 params: Optional[PinSageParams] = None):
        self.gather = gather_fn(gather_impl)
        tcfg, mcfg = cfg.train, cfg.model
        if mcfg.in_dim != features.shape[1]:
            cfg = cfg.replace(model=dataclasses.replace(
                mcfg, in_dim=features.shape[1]))
            mcfg = cfg.model
        if tcfg.dtype != "float32":
            raise ValueError(
                f"train.dtype={tcfg.dtype!r}: the port trains in float32 "
                f"only (kernels K2 and K3 take f32)")
        if tcfg.batch_size % mesh.n_dev:
            raise ValueError(f"batch_size {tcfg.batch_size} must divide "
                             f"over {mesh.n_dp}x{mesh.n_graph} ranks")
        width = nbhds[1].shape[1]
        if tcfg.hard_negatives and tcfg.hn_max > width:
            raise ValueError(
                f"hn_max={tcfg.hn_max} exceeds the stored neighborhood "
                f"width {width} (precompute with t_precompute >= hn_max)")
        if tcfg.fullgraph_forward not in ("auto", "on", "off"):
            raise ValueError(f"train.fullgraph_forward must be auto|on|off, "
                             f"got {tcfg.fullgraph_forward!r}")
        self.mesh, self.cfg, self.n_items = mesh, cfg, n_items
        self.device = dev = mesh.device
        g = mesh.n_graph
        self.b_local = tcfg.batch_size // mesh.n_dev

        # row-shard the node tables over graph (rows padded to g)
        n_pad = pad_to_multiple(n_items, g)
        rows = n_pad // g
        self.rows_local = rows
        mine = slice(mesh.graph_index * rows, (mesh.graph_index + 1) * rows)

        def shard(arr, dtype):
            full = np.zeros((n_pad,) + arr.shape[1:], dtype=dtype)
            full[:n_items] = arr
            return torch.as_tensor(full[mine].copy(), device=dev)

        self.features = shard(np.asarray(features), np.float32)
        nb_w = np.asarray(nbhds[0], np.float32)
        nb_n = np.asarray(nbhds[1], np.int32)
        self.nbhd_packed = shard(pack_nbhds_np(nb_w, nb_n, mcfg.T), np.int32)
        # hard negatives need single node ids at ranks up to hn_max > T:
        # the table is kept flattened, [n_pad * width, 1], so a negative
        # costs one int32 in the gather (row shards stay aligned: n_pad
        # divides g)
        self.hn_width = width
        self.nbhd_n_flat = None
        if tcfg.hard_negatives:
            _check_hard_negative_extent(n_pad, width)
            self.nbhd_n_flat = shard(nb_n, np.int32).reshape(-1, 1)
        self.positives = torch.as_tensor(np.asarray(positives, np.int32),
                                         device=dev)

        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(tcfg.seed)
            params = init_pinsage(gen, mcfg.n_layers, features.shape[1],
                                  mcfg.hidden_dim, mcfg.out_dim,
                                  mcfg.bias_init)
        else:
            params = copy.deepcopy(params).to(dev)
        with torch.no_grad():
            for _, p in params.leaves():
                p.copy_(C.broadcast(p.detach(), 0))
        self.params = params
        self.opt = make_optimizer(params, tcfg)
        self.fullgraph = (tcfg.fullgraph_forward == "on" or (
            tcfg.fullgraph_forward == "auto" and fullgraph_wins(
                3 * self.b_local, rows, mcfg.n_layers, mcfg.T)))
        self.epoch = 0          # batches_done // batches_per_epoch
        self.batches_done = 0   # exact progress (chunks may end mid-epoch)

    # ----------------------------------------------------------- gathers

    def _rows(self, table, ids):
        return self.gather(table, ids, self.mesh.graph_group)

    def _nbhds(self, ids):
        return unpack_nbhd_rows(self._rows(self.nbhd_packed, ids),
                                self.cfg.model.T)

    # ------------------------------------------------------------- steps

    def sample(self, shared: torch.Generator, own: torch.Generator
               ) -> torch.Tensor:
        """This rank's [b_local, 3] batch: positives from ``shared`` (the
        rank's block of one global permutation, with
        ``exact_batch_sampling``) or ``own``; negatives from ``own``, hard
        ones gathered from the sharded flattened neighborhood table."""
        tcfg, b = self.cfg.train, self.b_local
        if tcfg.exact_batch_sampling:
            pos_all = sample_positive_rows(shared, self.positives,
                                           tcfg.batch_size, exact=True)
            pos = pos_all[self.mesh.rank * b:(self.mesh.rank + 1) * b]
        else:
            pos = sample_positive_rows(own, self.positives, b)
        hard = tcfg.hard_negatives and (
            tcfg.hn_start_epoch == 0 or self.opt.count
            >= tcfg.hn_start_epoch * tcfg.batches_per_epoch)
        if hard:
            ranks = torch.randint(tcfg.hn_min, tcfg.hn_max, (b,),
                                  generator=own, device=self.device)
            flat = pos[:, 0] * self.hn_width + ranks.to(torch.int32)
            neg = self._rows(self.nbhd_n_flat, flat)[:, 0]
        else:
            neg = sample_easy_negatives(own, pos, self.n_items)
        return torch.cat([pos, neg[:, None].to(torch.int32)], dim=1)

    def local_loss(self, batch: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global loss: its batch mean of the
        max-margin loss over the number of ranks."""
        mcfg, p = self.cfg.model, self.params
        nodes = torch.cat([batch[:, 0], batch[:, 1], batch[:, 2]])
        if self.fullgraph:
            # each graph shard convolves its own rows per layer, fetching
            # neighbor activations with the same collective gather
            local_w, local_n = unpack_nbhd_rows(self.nbhd_packed, mcfg.T)
            h = self.features
            for layer in p.layers:
                h_nb = self._rows(h, local_n.reshape(-1)).reshape(
                    local_n.shape[0], mcfg.T, h.shape[1])
                h = conv_apply(layer, h, h_nb, local_w)
            emb = head_apply(p, self._rows(h, nodes))
        else:
            emb = forward_with_gather(
                p, lambda ids: self._rows(self.features, ids), self._nbhds,
                nodes, mcfg.n_layers, mcfg.T)
        h_q, h_pos, h_neg = emb.chunk(3)
        return max_margin_loss(h_q, h_pos, h_neg,
                               self.cfg.train.margin) / self.mesh.n_dev

    def gradients(self, batch: torch.Tensor
                  ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The global loss (a device scalar) and the global-batch gradient
        of every leaf (``params.leaves()`` order) for this rank's
        ``batch`` [b_local, 3]: one all-reduce of a flat buffer."""
        loss = self.local_loss(batch)
        grads = torch.autograd.grad(loss, self.opt.params)
        flat = C.all_reduce(torch.cat([g.reshape(-1) for g in grads]
                                      + [loss.detach().reshape(1)]))
        total = flat[:-1].split([g.numel() for g in grads])
        return flat[-1], [t.view_as(g) for t, g in zip(total, grads)]

    def step(self, batch: torch.Tensor) -> torch.Tensor:
        """One Adam step on this rank's ``batch``; returns the global
        loss."""
        loss, grads = self.gradients(batch)
        self.opt.step(grads)
        return loss

    def train_chunk(self, n_batches: int, batches=None) -> np.ndarray:
        """``n_batches`` steps; returns their global losses.  ``batches``
        (a list of this rank's [b_local, 3] batches) replaces the draws."""
        if batches is None:
            seed, b0 = self.cfg.train.seed + 1, self.batches_done
            shared = seeded_generator([seed, b0], self.device)
            own = seeded_generator([seed, b0, self.mesh.rank], self.device)
            losses = [self.step(self.sample(shared, own))
                      for _ in range(n_batches)]
        else:
            if len(batches) != n_batches:
                raise ValueError(f"{len(batches)} batches for a chunk of "
                                 f"{n_batches}")
            losses = [self.step(torch.as_tensor(b, device=self.device))
                      for b in batches]
        self.batches_done += n_batches
        self.epoch = self.batches_done // self.cfg.train.batches_per_epoch
        return torch.stack(losses).cpu().numpy()

    def train_epochs(self, epochs: Optional[int] = None,
                     verbose: bool = False,
                     save_path: str | None = None) -> None:
        """Chunks of ``checkpoint_every_batches`` batches spanning epoch
        boundaries, until ``epochs`` epochs are done; ``save_path``
        checkpoints after every chunk."""
        tcfg = self.cfg.train
        epochs = epochs if epochs is not None else tcfg.epochs
        total = epochs * tcfg.batches_per_epoch
        chunk = min(tcfg.checkpoint_every_batches, total)
        while self.batches_done < total:
            t0 = time.time()
            losses = self.train_chunk(min(chunk, total - self.batches_done))
            if save_path is not None:
                self.save(save_path)
            if verbose:
                print(f"epoch {self.epoch}/{epochs}: loss={losses[-1]:.6f} "
                      f"({time.time() - t0:.2f}s)")

    # ------------------------------------------------------- checkpoints

    def save(self, path: str) -> None:
        """Rank 0 writes ``utils.checkpoint.save_state`` (the scalars of
        ``PinSageTrainer``: epochs done, batches done in the epoch), which
        ``PinSageTrainer`` resumes and both packages read params from."""
        bpe = self.cfg.train.batches_per_epoch
        if self.mesh.rank == 0:
            e, b = divmod(self.batches_done, bpe)
            save_state(path, self.params, self.opt,
                       {"epochs_done": e, "batches_done": b})
        dist.barrier()

    def load(self, path: str) -> bool:
        """Every rank reads ``path`` (a ``save_state`` checkpoint of
        either trainer); False where there is none."""
        if not os.path.isfile(path):
            return False
        scalars = load_state(path, self.params, self.opt)
        bpe = self.cfg.train.batches_per_epoch
        self.batches_done = (int(scalars["epochs_done"]) * bpe
                             + int(scalars["batches_done"]))
        self.epoch = self.batches_done // bpe
        return True

    # ------------------------------------------------------------- embed

    def embed(self, batch_size: int = 4096,
              ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Embed ``ids`` (every item when None) -> numpy [len, out_dim] on
        every rank: blocks of ``batch_size`` ids (padded to the number of
        ranks, wrapping modulo the catalog) split over the ranks, each
        slice through the frontier forward with collective gathers (K3 on
        the GPU), the slices all-gathered."""
        mcfg, n_dev, rank = self.cfg.model, self.mesh.n_dev, self.mesh.rank
        ids = (np.arange(self.n_items, dtype=np.int64) if ids is None
               else np.asarray(ids, dtype=np.int64).reshape(-1))
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_items):
            raise IndexError(f"ids outside [0, {self.n_items})")
        bs = pad_to_multiple(batch_size, n_dev)
        per_rank = bs // n_dev
        outs = []
        with torch.inference_mode():
            for start in range(0, len(ids), bs):
                block = np.take(ids, np.arange(start, start + bs),
                                mode="wrap")
                mine = torch.as_tensor(
                    block[rank * per_rank:(rank + 1) * per_rank],
                    dtype=torch.int32, device=self.device)
                out = forward_with_gather(
                    self.params, lambda i: self._rows(self.features, i),
                    self._nbhds, mine, mcfg.n_layers, mcfg.T)
                full = C.all_gather(out).reshape(bs, -1)
                outs.append(full[:min(bs, len(ids) - start)].cpu().numpy())
        return np.concatenate(outs, axis=0)
