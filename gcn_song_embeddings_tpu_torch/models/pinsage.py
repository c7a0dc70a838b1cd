"""PinSage model: importance-weighted conv stack + G1/G2 head, in PyTorch.

Same math and parameter layouts as gcn_song_embeddings_tpu/models/
pinsage.py:

  conv(h_self [B,Din], neighbors, w [B,T]):
      agg  = sum_t w_t * leaky_relu(h_nb_t @ Wq^T + bq) / sum_t w_t   (K2)
      out  = leaky_relu(h_self @ Ww[:, :Din]^T + agg @ Ww[:, Din:]^T + bw)
      out  = out / ||out||_2
  head(x) = G2 @ leaky_relu(G1 @ x + b1)          (G2 has no bias)

The aggregation goes through ``ops.agg.conv_aggregate``: kernel K2 on
the GPU, its plain version on the CPU.  The dense products of the W half
and the head stay ``torch.matmul``.  Layer 0 consumes raw features; every
layer outputs ``out_dim``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from gcn_song_embeddings_tpu_torch.ops.agg import conv_aggregate


class ConvParams(nn.Module):
    """One conv layer: Wq [hidden, in], bq [hidden], Ww [out, in+hidden],
    bw [out] (the JAX package's layouts)."""

    def __init__(self, Wq, bq, Ww, bw):
        super().__init__()
        self.Wq = nn.Parameter(Wq)
        self.bq = nn.Parameter(bq)
        self.Ww = nn.Parameter(Ww)
        self.bw = nn.Parameter(bw)


class PinSageParams(nn.Module):
    """Conv layers + head: G1_w [out, out], G1_b [out], G2_w [out, out]."""

    def __init__(self, layers, G1_w, G1_b, G2_w):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.G1_w = nn.Parameter(G1_w)
        self.G1_b = nn.Parameter(G1_b)
        self.G2_w = nn.Parameter(G2_w)


def _xavier_uniform(shape: tuple[int, int], generator: torch.Generator
                    ) -> torch.Tensor:
    """U(-a, a), a = sqrt(6 / (fan_in + fan_out)), (fan_out, fan_in) layout."""
    fan_out, fan_in = shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * a


def init_pinsage(generator: torch.Generator, n_layers: int, in_dim: int,
                 hidden_dim: int, out_dim: int, bias_init: float = 0.3
                 ) -> PinSageParams:
    """Xavier-uniform weights, biases filled with ``bias_init``, on the
    generator's device.  Layer l takes ``in_dim`` for l=0 and ``out_dim``
    afterwards."""
    dev = generator.device
    in_dims = [in_dim] + [out_dim] * (n_layers - 1)
    layers = []
    for l in range(n_layers):
        wq = _xavier_uniform((hidden_dim, in_dims[l]), generator)
        ww = _xavier_uniform((out_dim, in_dims[l] + hidden_dim), generator)
        layers.append(ConvParams(
            wq, torch.full((hidden_dim,), bias_init, device=dev),
            ww, torch.full((out_dim,), bias_init, device=dev)))
    g1 = _xavier_uniform((out_dim, out_dim), generator)
    g2 = _xavier_uniform((out_dim, out_dim), generator)
    return PinSageParams(layers, g1,
                         torch.full((out_dim,), bias_init, device=dev), g2)


def conv_from_table(p: ConvParams, h_self: torch.Tensor,
                    table: torch.Tensor, nb_nodes: torch.Tensor,
                    nb_w: torch.Tensor) -> torch.Tensor:
    """One conv layer whose neighbors are rows ``nb_nodes`` [B, T] of
    ``table``: the aggregation never materializes them on the GPU (K2)."""
    agg = conv_aggregate(table, nb_nodes, nb_w, p.Wq, p.bq)
    d = h_self.shape[1]
    # split-W product: [a, b] @ M^T == a @ M[:, :d]^T + b @ M[:, d:]^T,
    # without materializing the [B, Din + hidden] concat
    new_h = F.leaky_relu(h_self @ p.Ww[:, :d].t() + agg @ p.Ww[:, d:].t()
                         + p.bw, 0.01)
    norm = torch.linalg.vector_norm(new_h, dim=1, keepdim=True)
    return new_h / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def conv_apply(p: ConvParams, h_self: torch.Tensor, h_nb: torch.Tensor,
               nb_w: torch.Tensor) -> torch.Tensor:
    """One PinSage convolution on explicit neighbor rows.

    h_self [B, Din]; h_nb [B, T, Din]; nb_w [B, T].  An all-zero
    neighborhood aggregates with denominator 1; a zero output row is left
    unnormalized."""
    b, t, din = h_nb.shape
    ids = torch.arange(b * t, dtype=torch.int32,
                       device=h_nb.device).reshape(b, t)
    return conv_from_table(p, h_self, h_nb.reshape(b * t, din), ids, nb_w)


def head_apply(params: PinSageParams, x: torch.Tensor) -> torch.Tensor:
    """G2(leaky_relu(G1(x))), not re-normalized."""
    hidden = F.leaky_relu(x @ params.G1_w.t() + params.G1_b, 0.01)
    return hidden @ params.G2_w.t()


def forward_with_gather(params: PinSageParams, gather_features,
                        gather_nbhds, nodeset: torch.Tensor, n_layers: int,
                        T: int) -> torch.Tensor:
    """Frontier forward: [B] nodes -> [B, out_dim].

    ``gather_features(ids) -> [m, in_dim]`` and ``gather_nbhds(ids) ->
    (weights [m, T], nodes [m, T])``.  Frontier l+1 is frontier l followed
    by its neighbors (no dedup: static size B*(T+1)^l), so layer l's self
    rows are h[:m] and its neighbor rows are h[m:]."""
    frontiers = [nodeset.to(torch.int32)]
    nb_per_level = []
    for _ in range(n_layers):
        f = frontiers[-1]
        nb_w, nb_n = gather_nbhds(f)
        nb_per_level.append(nb_w)
        frontiers.append(torch.cat([f, nb_n.reshape(-1).to(torch.int32)]))

    h = gather_features(frontiers[n_layers])
    for l in reversed(range(n_layers)):
        m = frontiers[l].shape[0]
        ids = m + torch.arange(m * T, dtype=torch.int32,
                               device=h.device).reshape(m, T)
        # the deepest frontier uses layers[0]
        h = conv_from_table(params.layers[n_layers - 1 - l], h[:m], h, ids,
                            nb_per_level[l])
    return head_apply(params, h)


def pinsage_forward(params: PinSageParams, features: torch.Tensor,
                    nbhd_weights: torch.Tensor, nbhd_nodes: torch.Tensor,
                    nodeset: torch.Tensor, n_layers: int, T: int
                    ) -> torch.Tensor:
    """Embed ``nodeset`` rows [B] -> [B, out_dim] through the frontier
    path, neighborhoods read from the precomputed top-T tables."""
    def gather_nbhds(ids):
        ids = ids.long()
        return nbhd_weights[ids, :T], nbhd_nodes[ids, :T]

    return forward_with_gather(params, lambda ids: features[ids.long()],
                               gather_nbhds, nodeset, n_layers, T)


def fullgraph_embeddings(params: PinSageParams, features: torch.Tensor,
                         nbhd_weights: torch.Tensor,
                         nbhd_nodes: torch.Tensor, n_layers: int, T: int,
                         block_rows: int = 131_072) -> torch.Tensor:
    """Pre-head activations for ALL items, one dense sweep per layer.

    Layer l's activation of node v does not depend on the batch, so each
    layer runs once over the catalog: N*(T+1) row touches per layer.
    Catalogs past ``block_rows`` run each layer in row blocks (every block
    still gathers from the full previous-layer table)."""
    nb_w = nbhd_weights[:, :T].contiguous()
    nb_n = nbhd_nodes[:, :T].to(torch.int32).contiguous()
    n = features.shape[0]
    h = features
    for l in range(n_layers):
        p = params.layers[l]
        h = torch.cat([conv_from_table(p, h[s:s + block_rows], h,
                                       nb_n[s:s + block_rows],
                                       nb_w[s:s + block_rows])
                       for s in range(0, n, block_rows)])
    return h


def embed_all(params: PinSageParams, features: torch.Tensor,
              nbhd_weights: torch.Tensor, nbhd_nodes: torch.Tensor,
              n_items: int, n_layers: int, T: int) -> torch.Tensor:
    """Embed every item -> [n_items, out_dim]: the full-catalog conv sweep
    (the JAX package's ``strategy="fullgraph"``), then the head."""
    with torch.inference_mode():
        h = fullgraph_embeddings(params, features, nbhd_weights, nbhd_nodes,
                                 n_layers, T)
        return head_apply(params, h)[:n_items]
