"""GNN model family: GraphSAGE / GAT / GCN encoders with unsupervised,
classification and regression training (own copy of
gcn_song_embeddings_tpu/models/gnnlib.py), in plain PyTorch on a device
(default: the GPU).

- Neighbors are sampled uniformly with replacement at a fixed fanout S,
  so every gather is a static [m, S] block; a degree-0 node samples
  itself.
- GAT attends over the S sampled edges and the self edge with one masked
  softmax; GCN is the sampled symmetric mean (self and neighbors
  averaged, one projection).
- Training is autograd + the port's Adam (``train/adam.py``, optax's
  update) at a constant rate.
- ``GCN_TPU_MATMUL_PRECISION`` (``utils.precision``) runs the layers'
  products, and their gradients', in one or three bf16 passes.

Randomness is an input: ``GNNCore.init_params`` gives the initial
parameters (``params_from_jax`` carries the JAX package's across) and
``GNNCore.draws`` each step's node ids and raw neighbor draws (integers
in [0, 2^30), taken modulo the degree), so the JAX package's can be fed
in.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gcn_song_embeddings_tpu_torch.ops.agg import (
    einsum,
    matmul,
    policy_passes,
)
from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator
from gcn_song_embeddings_tpu_torch.train.adam import Adam
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

LAYERS = ("sage", "gcn", "gat")
TASKS = ("unsupervised", "classification", "regression")
DRAW_RANGE = 1 << 30  # raw neighbor draws are integers in [0, DRAW_RANGE)

Params = dict[str, dict[str, torch.Tensor]]


def degree_onehot(degrees: np.ndarray, n_buckets: int = 32) -> np.ndarray:
    """log-degree bucket one-hot fallback features."""
    buckets = np.clip(np.log1p(degrees).astype(np.int64), 0, n_buckets - 1)
    out = np.zeros((len(degrees), n_buckets), dtype=np.float32)
    out[np.arange(len(degrees)), buckets] = 1.0
    return out


def uniform_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                      nodes: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[m] nodes -> [m, S] neighbors picked by the raw draws ``r`` [m, S]
    (with replacement; degree-0 nodes sample themselves)."""
    start = indptr[nodes]
    deg = indptr[nodes + 1] - start
    offs = r.long() % torch.clamp(deg, min=1)[:, None]
    nb = indices[torch.clamp(start[:, None] + offs, max=indices.shape[0] - 1)]
    return torch.where((deg > 0)[:, None], nb, nodes[:, None])


def init_gnn_layer(gen: torch.Generator, layer: str, d_in: int,
                   d_out: int) -> dict[str, torch.Tensor]:
    """He-scaled normal weights (and GAT's two attention vectors at 0.1)
    from ``gen``, on its device."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    if layer == "sage":
        return {"W": normal(2 * d_in, d_out)
                * float(np.sqrt(2.0 / (2 * d_in)))}
    if layer == "gcn":
        return {"W": normal(d_in, d_out) * float(np.sqrt(2.0 / d_in))}
    if layer == "gat":
        return {"W": normal(d_in, d_out) * float(np.sqrt(2.0 / d_in)),
                "a_l": normal(d_out) * 0.1, "a_r": normal(d_out) * 0.1}
    raise ValueError(f"unknown layer type {layer!r}; choose from {LAYERS}")


def params_from_jax(params: dict, device=None) -> Params:
    """A JAX ``{"l1": {...}, "l2": {...}}`` params dict of arrays -> the
    port's parameters (f32 tensors on ``device``, default: the GPU)."""
    dev = resolve_device(device)
    return {name: {k: torch.tensor(np.asarray(v, dtype=np.float32),
                                   device=dev)
                   for k, v in layer.items()}
            for name, layer in params.items()}


def gnn_layer_apply(p: dict, layer: str, h_self: torch.Tensor,
                    h_nb: torch.Tensor, activate: bool = True
                    ) -> torch.Tensor:
    """One sampled-neighborhood aggregation: [m, d] self + [m, S, d]
    neighbors -> [m, d_out].

    Under the matmul precision policy (``utils.precision``) each product
    runs in its bf16 passes, forward and backward, as the JAX package's
    default precision runs it on the TPU; unset, in f32."""
    passes = policy_passes(h_self, p["W"])
    if layer == "sage":
        z = matmul(torch.cat([h_self, h_nb.mean(dim=1)], dim=1), p["W"],
                   passes)
    elif layer == "gcn":
        s = h_nb.shape[1]
        z = matmul((h_self + h_nb.sum(dim=1)) / float(s + 1), p["W"],
                   passes)
    elif layer == "gat" and passes is None:
        # the neighbors' projections h_nb @ W enter only through linear
        # maps, so W is applied after the attention-weighted sum: no
        # [m, S, d_out] tensor (exact in f32, not under rounding)
        z_self = h_self @ p["W"]                     # [m, d_out]
        e_l = z_self @ p["a_l"]                      # [m]
        e_self = F.leaky_relu(e_l + z_self @ p["a_r"], 0.2)
        e_nb = F.leaky_relu(e_l[:, None] + h_nb @ (p["W"] @ p["a_r"]), 0.2)
        w = torch.softmax(torch.cat([e_self[:, None], e_nb], dim=1), dim=1)
        z = w[:, :1] * z_self + torch.einsum("ms,msd->md", w[:, 1:],
                                             h_nb) @ p["W"]
    elif layer == "gat":
        # rounded, in the JAX package's association: each product's
        # operands are the ones the TPU rounds
        z_self = matmul(h_self, p["W"], passes)      # [m, d_out]
        z_nb = matmul(h_nb, p["W"], passes)          # [m, S, d_out]
        e_l = einsum("md,d->m", z_self, p["a_l"], passes)
        e_self = F.leaky_relu(
            e_l + einsum("md,d->m", z_self, p["a_r"], passes), 0.2)
        e_nb = F.leaky_relu(
            e_l[:, None] + einsum("msd,d->ms", z_nb, p["a_r"], passes), 0.2)
        w = torch.softmax(torch.cat([e_self[:, None], e_nb], dim=1), dim=1)
        z = w[:, :1] * z_self + einsum("ms,msd->md", w[:, 1:], z_nb,
                                       passes)
    else:
        raise ValueError(f"unknown layer type {layer!r}")
    return torch.relu(z) if activate else z


class GNNCore:
    """Two-layer sampled GNN encoder + Adam trainer for one of the three
    tasks, over a CSR adjacency (indptr/indices over one node universe),
    on ``device``."""

    def __init__(self, layer: str = "sage", task: str = "unsupervised",
                 hidden_dim: int = 128, out_dim: int = 128,
                 n_sample: int = 10, steps: int = 1500, batch: int = 512,
                 lr: float = 1e-3, margin: float = 3.0, seed: int = 0,
                 device=None):
        if layer not in LAYERS:
            raise ValueError(f"layer must be one of {LAYERS}, got {layer!r}")
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        self.layer = layer
        self.task = task
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim
        self.n_sample = n_sample
        self.steps = steps
        self.batch = batch
        self.lr = lr
        self.margin = margin
        self.seed = seed
        self.device = device
        self.losses: np.ndarray | None = None
        self._params: Params | None = None

    # -- randomness --------------------------------------------------------
    def init_params(self, in_dim: int, out_dim: int, dev) -> Params:
        gen = seeded_generator([self.seed], dev)
        return {"l1": init_gnn_layer(gen, self.layer, in_dim,
                                     self.hidden_dim),
                "l2": init_gnn_layer(gen, self.layer, self.hidden_dim,
                                     out_dim)}

    def encode_draws(self, m: int, gen: torch.Generator
                     ) -> tuple[torch.Tensor, ...]:
        """The encoder's raw neighbor draws for m nodes: layer-1 frontier
        [m, S], its neighbors [m*S, S], the nodes' own [m, S]."""
        S = self.n_sample
        return tuple(torch.randint(0, DRAW_RANGE, shape, generator=gen,
                                   device=gen.device)
                     for shape in ((m, S), (m * S, S), (m, S)))

    def draws(self, step: int, n_nodes: int, pool: int) -> dict:
        """Step ``step``'s draws.  Unsupervised: ``nodes``, ``neg`` [B] node
        ids and ``pos`` [B, 1] raw draws of a neighbor; supervised:
        ``idx`` [B] into the labeled pool.  Both: ``encode`` (see
        ``encode_draws``, m = 3B unsupervised, B supervised)."""
        gen, B, dev = self._gen, self.batch, self._gen.device
        if self.task == "unsupervised":
            return {"nodes": torch.randint(0, n_nodes, (B,), generator=gen,
                                           device=dev),
                    "pos": torch.randint(0, DRAW_RANGE, (B, 1),
                                         generator=gen, device=dev),
                    "neg": torch.randint(0, n_nodes, (B,), generator=gen,
                                         device=dev),
                    "encode": self.encode_draws(3 * B, gen)}
        return {"idx": torch.randint(0, pool, (B,), generator=gen,
                                     device=dev),
                "encode": self.encode_draws(B, gen)}

    # -- forward -----------------------------------------------------------
    def encode(self, p: Params, nodes: torch.Tensor, r) -> torch.Tensor:
        feats, ip, ix, S = self._feats, self._ip, self._ix, self.n_sample
        ra, rb, rc = r
        nb1 = uniform_neighbors(ip, ix, nodes, ra)              # [m, S]
        flat1 = nb1.reshape(-1)
        nb2 = uniform_neighbors(ip, ix, flat1, rb)              # [mS, S]
        h1_frontier = gnn_layer_apply(p["l1"], self.layer, feats[flat1],
                                      feats[nb2])               # [mS, h]
        nb1b = uniform_neighbors(ip, ix, nodes, rc)
        h1_self = gnn_layer_apply(p["l1"], self.layer, feats[nodes],
                                  feats[nb1b])                  # [m, h]
        h1_nb = h1_frontier.reshape(nodes.shape[0], S, -1)
        unsup = self.task == "unsupervised"
        h2 = gnn_layer_apply(p["l2"], self.layer, h1_self, h1_nb,
                             activate=unsup)
        if unsup:
            norm = torch.linalg.vector_norm(h2, dim=1, keepdim=True)
            h2 = h2 / torch.clamp(norm, min=1e-12)
        return h2

    def loss(self, p: Params, d: dict) -> torch.Tensor:
        if self.task == "unsupervised":
            nodes, neg = d["nodes"].long(), d["neg"].long()
            pos = uniform_neighbors(self._ip, self._ix, nodes, d["pos"])[:, 0]
            emb = self.encode(p, torch.cat([nodes, pos, neg]), d["encode"])
            zq, zp, zn = torch.chunk(emb, 3)
            d_pos = torch.sum((zq - zp) ** 2, dim=1)
            d_neg = torch.sum((zq - zn) ** 2, dim=1)
            return torch.mean(torch.clamp(d_pos - d_neg + self.margin,
                                          min=0.0))
        nodes = self._pool[d["idx"].long()]
        out = self.encode(p, nodes, d["encode"])
        if self.task == "classification":
            return F.cross_entropy(out, self._y[nodes])
        return torch.mean((out[:, 0] - self._y[nodes]) ** 2)

    # -- training ----------------------------------------------------------
    def fit(self, indptr: np.ndarray, indices: np.ndarray,
            features: np.ndarray | None, n_nodes: int,
            labels: np.ndarray | None = None) -> np.ndarray:
        """Train; returns the [n_nodes, out] outputs of every node
        (embeddings unsupervised, logits or values supervised)."""
        dev = resolve_device(self.device)
        if features is None:
            features = degree_onehot(np.diff(indptr))
        self._feats = torch.as_tensor(np.asarray(features, np.float32),
                                      device=dev)
        self._ip = torch.as_tensor(np.asarray(indptr, np.int64), device=dev)
        self._ix = torch.as_tensor(np.asarray(indices, np.int64), device=dev)

        pool = None
        if self.task == "unsupervised":
            head_dim = self.out_dim
        else:
            if labels is None:
                raise ValueError(f"task={self.task!r} requires labels")
            labels = np.asarray(labels)
            mask = (labels >= 0) if self.task == "classification" else \
                np.isfinite(labels.astype(np.float64))
            pool_ids = np.nonzero(mask)[0]
            if pool_ids.shape[0] == 0:
                raise ValueError("no labeled nodes to train on")
            pool = pool_ids.shape[0]
            self._pool = torch.as_tensor(pool_ids, device=dev)
            if self.task == "classification":
                head_dim = int(labels.max()) + 1
                self._y = torch.as_tensor(labels.astype(np.int64),
                                          device=dev)
            else:
                head_dim = 1
                self._y = torch.as_tensor(
                    np.nan_to_num(labels).astype(np.float32), device=dev)

        self._gen = seeded_generator([self.seed, 1], dev)
        params = self.init_params(self._feats.shape[1], head_dim, dev)
        leaves = [t for layer in params.values() for t in layer.values()]
        for t in leaves:
            t.requires_grad_(True)
        opt = Adam(leaves, self.lr, 1.0, 1)   # constant rate
        losses = []
        for step in range(self.steps):
            loss = self.loss(params, self.draws(step, n_nodes, pool))
            grads = torch.autograd.grad(loss, leaves)
            opt.step(grads)
            losses.append(loss.detach())
        self.losses = (torch.stack(losses).cpu().numpy() if losses
                       else np.zeros(0, np.float32))
        self._params = {k: {n: t.detach() for n, t in layer.items()}
                        for k, layer in params.items()}
        return self.transform(np.arange(n_nodes))

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def transform(self, nodes: np.ndarray, block: int = 2048,
                  n_draws: int = 1) -> np.ndarray:
        """Outputs of ``nodes``, ``block`` at a time, each block's draws from
        a generator seeded from (seed + 7, block start, draw); ``n_draws``
        > 1 averages several neighbor draws."""
        if self._params is None:
            raise RuntimeError("fit() before transform()")
        nodes = torch.as_tensor(np.asarray(nodes, np.int64),
                                device=self._feats.device)
        out = []
        for s in range(0, nodes.shape[0], block):
            blk = nodes[s:s + block]
            res = sum(self.encode(self._params, blk, self.encode_draws(
                blk.shape[0], seeded_generator([self.seed + 7, s, d],
                                               blk.device)))
                      for d in range(n_draws)) / n_draws
            out.append(res.cpu())
        return torch.cat(out).numpy()

    def predict(self, nodes: np.ndarray, n_draws: int = 1) -> np.ndarray:
        """Class ids (classification) or scalar values (regression)."""
        out = self.transform(nodes, n_draws=n_draws)
        if self.task == "classification":
            return out.argmax(axis=1)
        if self.task == "regression":
            return out[:, 0]
        return out


class GNN:
    """The lib's facade: pick an encoder family (graphsage / gat / gcn)
    and a task, ``fit`` a CSR adjacency + optional features (+ labels),
    then ``generate_embeddings`` / ``predict``."""

    def __init__(self, model: str = "graphsage", task: str = "unsupervised",
                 **kwargs):
        aliases = {"graphsage": "sage", "sage": "sage",
                   "gat": "gat", "gcn": "gcn"}
        key = model.lower()
        if key not in aliases:
            raise ValueError(
                f"model must be one of graphsage/gat/gcn, got {model!r}")
        self.core = GNNCore(layer=aliases[key], task=task, **kwargs)
        self._output: np.ndarray | None = None

    def fit(self, indptr, indices, features=None, labels=None,
            n_nodes=None):
        n_nodes = n_nodes if n_nodes is not None else len(indptr) - 1
        self._output = self.core.fit(indptr, indices, features, n_nodes,
                                     labels=labels)
        return self

    def generate_embeddings(self) -> np.ndarray:
        if self._output is None:
            raise RuntimeError("fit() before generate_embeddings()")
        return self._output

    def predict(self, nodes) -> np.ndarray:
        return self.core.predict(np.asarray(nodes))
