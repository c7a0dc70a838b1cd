"""PinSage model: importance-weighted conv stack + G1/G2 head, in PyTorch.

Same math and parameter layouts as gcn_song_embeddings_tpu/models/
pinsage.py:

  conv(h_self [B,Din], neighbors, w [B,T]):
      agg  = sum_t w_t * leaky_relu(h_nb_t @ Wq^T + bq) / sum_t w_t   (K2)
      out  = leaky_relu(h_self @ Ww[:, :Din]^T + agg @ Ww[:, Din:]^T + bw)
      out  = out / ||out||_2
  head(x) = G2 @ leaky_relu(G1 @ x + b1)          (G2 has no bias)

The aggregation goes through ``aggregate`` (``ops.agg.conv_aggregate``),
differentiable on both devices: on the GPU the frontier forward (the
train step, and embedding a node set) runs kernel K3 and the
full-catalog sweep runs K2; on the CPU both run their plain version.
``aggregate`` takes any width and any T, as the JAX package's einsum
does: it pads Din and H with zero columns to the kernels' multiples of 4
and cuts K3's neighbor columns into slices of at most 64.  The dense
products of the W half and the head stay ``torch.matmul``.  Layer 0
consumes raw features; every layer outputs ``out_dim``.

Mixed precision (``train.dtype="bfloat16"`` or ``"float16"``) follows
the JAX package: ``cast_params`` gives the step 16-bit copies of the f32
master weights, the feature table is 16-bit, and every product
accumulates in f32 and returns f32 (16-bit operands upcast exactly
before a dense product, the 16-bit forms of K2 and K3 inside the
aggregation).  A layer's output is
f32; ``fullgraph_embeddings`` stores it back in the features' dtype.
With f32 params and features every function here runs as before.

The matmul precision policy (``utils.precision``,
``GCN_TPU_MATMUL_PRECISION=default|high``) runs every product of an f32
step or embed in one or three bf16 passes, forward and backward, as the
JAX package's default precision does on the TPU: the aggregation's Q
product (the kernels' bf16x forms), the W half and the head
(``ops.agg.matmul`` on rounded operands).  Elementwise ops, the norm and
the loss stay f32; a 16-bit step's products run as before.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gcn_song_embeddings_tpu_torch.ops.agg import (
    MAX_T,
    SIXTEEN,
    _denominator,
    _f32,
    conv_aggregate,
    matmul,
    policy_passes,
)

WIDTH_MULTIPLE = 4  # the aggregation kernels' 16-byte loads (f32)
WIDTH_MULTIPLE_16 = 8  # the same loads of 16-bit (bf16 or f16) rows


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

    def leaves(self) -> list[tuple[str, nn.Parameter]]:
        """(name, parameter) in the JAX package's leaf order, named as its
        key paths below ``['params']``: ``layers[0].Wq``, ``layers[0].bq``,
        ..., ``G1_w``, ``G1_b``, ``G2_w``.  (``parameters()`` lists the
        head first.)"""
        out = [(f"layers[{i}].{f}", getattr(layer, f))
               for i, layer in enumerate(self.layers)
               for f in ("Wq", "bq", "Ww", "bw")]
        return out + [(f, getattr(self, f)) for f in ("G1_w", "G1_b", "G2_w")]


def cast_params(params: PinSageParams, dtype: torch.dtype):
    """Copies of ``params`` in ``dtype`` under autograd (the gradient of
    each master leaf flows back through the cast, rounded to ``dtype`` as
    in the JAX package), with the attributes the model functions read."""
    def cast(module, names):
        return {f: getattr(module, f).to(dtype) for f in names}

    return SimpleNamespace(
        layers=[SimpleNamespace(**cast(layer, ("Wq", "bq", "Ww", "bw")))
                for layer in params.layers],
        **cast(params, ("G1_w", "G1_b", "G2_w")))


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


def pack_nbhds(nbhd_weights: torch.Tensor, nbhd_nodes: torch.Tensor,
               T: int) -> torch.Tensor:
    """The top-T (weights, nodes) columns as ONE [N, 2T] int32 table, the
    f32 weights bit-cast to int32, so each frontier level costs a single
    row gather (the JAX package's layout)."""
    w = nbhd_weights[:, :T].to(torch.float32).contiguous().view(torch.int32)
    return torch.cat([w, nbhd_nodes[:, :T].to(torch.int32)], dim=1)


def unpack_nbhd_rows(rows: torch.Tensor, T: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_nbhds`` for gathered rows [m, 2T] -> (w [m, T]
    f32, nodes [m, T] int32)."""
    return rows[:, :T].contiguous().view(torch.float32), rows[:, T:]


def pack_nbhds_np(nbhd_weights, nbhd_nodes, T: int) -> np.ndarray:
    """NumPy twin of ``pack_nbhds`` (same [N, 2T] bit-cast layout)."""
    w = np.ascontiguousarray(
        np.asarray(nbhd_weights)[:, :T], dtype=np.float32).view(np.int32)
    return np.concatenate(
        [w, np.asarray(nbhd_nodes)[:, :T].astype(np.int32)], axis=1)


def packed_nbhd_gather(packed: torch.Tensor, T: int):
    """``gather_nbhds(ids)`` over a ``pack_nbhds`` table."""
    def gather_nbhds(ids):
        return unpack_nbhd_rows(packed[ids.long()], T)
    return gather_nbhds


def aggregate(table: torch.Tensor, nb_nodes: torch.Tensor,
              nb_w: torch.Tensor, Wq: torch.Tensor, bq: torch.Tensor,
              mode: str = "stream", block_rows: int | None = None
              ) -> torch.Tensor:
    """``conv_aggregate`` at any Din, H and T.

    A bf16 or f16 table with a Wq of its type aggregates in that 16-bit
    form; an f32 table takes Wq upcast, as the JAX package promotes the
    product's operands; bq is upcast either way.  A Din that is not a
    multiple of 4 (8 for a 16-bit table, or an f32 one in bf16 passes
    under the precision policy) or an H that is not one of 4 is
    padded with zero columns (of the table and Wq, and zero entries of
    bq): a zero column
    adds exactly 0 to each product and projects to leaky_relu(0) = 0, and
    the padded output columns are cut off, so their gradient is dropped.
    For mode "dma" past K3's T <= 64 the neighbor columns are cut into
    slices of at most 64: each slice's mean times its denominator is its
    weighted sum, and the sums over the row's whole denominator give the
    mean (an all-zero row keeps denominator 1)."""
    sixteen = table.dtype == Wq.dtype and table.dtype in SIXTEEN
    if not sixteen:
        table, Wq = _f32(table), _f32(Wq)
    bq = _f32(bq)
    din, hdim = table.shape[1], Wq.shape[0]
    bf16_loads = sixteen or policy_passes(table, Wq) is not None
    pad_d = -din % (WIDTH_MULTIPLE_16 if bf16_loads else WIDTH_MULTIPLE)
    pad_h = -hdim % WIDTH_MULTIPLE
    if pad_d or pad_h:
        table = F.pad(table, (0, pad_d))
        Wq = F.pad(Wq, (0, pad_d, 0, pad_h))
        bq = F.pad(bq, (0, pad_h))
    t = nb_nodes.shape[1]
    if mode == "dma" and t > MAX_T:
        total = 0.0
        for s in range(0, t, MAX_T):
            w_s = nb_w[:, s:s + MAX_T]
            total = total + conv_aggregate(
                table, nb_nodes[:, s:s + MAX_T], w_s, Wq, bq,
                mode) * _denominator(w_s)
        out = total / _denominator(nb_w)
    else:
        out = conv_aggregate(table, nb_nodes, nb_w, Wq, bq, mode, block_rows)
    return out[:, :hdim] if pad_h else out


def conv_from_table(p: ConvParams, h_self: torch.Tensor,
                    table: torch.Tensor, nb_nodes: torch.Tensor,
                    nb_w: torch.Tensor, mode: str = "stream",
                    block_rows: int | None = None) -> torch.Tensor:
    """One conv layer whose neighbors are rows ``nb_nodes`` [B, T] of
    ``table``: the aggregation never materializes them on the GPU (K2 for
    mode "stream", K3 for "dma").  Returns f32 (16-bit operands of the
    dense products upcast: products exact, sums in f32; f32 ones in the
    precision policy's bf16 passes)."""
    agg = aggregate(table, nb_nodes, nb_w, p.Wq, p.bq, mode, block_rows)
    d = h_self.shape[1]
    passes = policy_passes(h_self, p.Ww)
    # split-W product: [a, b] @ M^T == a @ M[:, :d]^T + b @ M[:, d:]^T,
    # without materializing the [B, Din + hidden] concat
    new_h = F.leaky_relu(matmul(h_self, p.Ww[:, :d].t(), passes)
                         + matmul(agg, p.Ww[:, d:].t(), passes)
                         + _f32(p.bw), 0.01)
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
    """G2(leaky_relu(G1(x))) in f32, not re-normalized (f32 products in
    the precision policy's bf16 passes)."""
    passes = policy_passes(x, params.G1_w)
    hidden = F.leaky_relu(matmul(x, params.G1_w.t(), passes)
                          + _f32(params.G1_b), 0.01)
    return matmul(hidden, params.G2_w.t(), passes)


def forward_with_gather(params: PinSageParams, gather_features,
                        gather_nbhds, nodeset: torch.Tensor, n_layers: int,
                        T: int) -> torch.Tensor:
    """Frontier forward: [B] nodes -> [B, out_dim].

    ``gather_features(ids) -> [m, in_dim]`` and ``gather_nbhds(ids) ->
    (weights [m, T], nodes [m, T])``.  Frontier l+1 is frontier l followed
    by its neighbors (no dedup: static size B*(T+1)^l), so layer l's self
    rows are h[:m] and its neighbor rows are h[m:], node i's at h[m + i T
    ..].  The aggregation runs K3 on the GPU over h[m:] (gathered row
    batches of this size are what it was written for), so its backward's
    products run over the m T rows that it names and not over the m self
    rows too."""
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
        ids = torch.arange(m * T, dtype=torch.int32,
                           device=h.device).reshape(m, T)
        # the deepest frontier uses layers[0]
        h = conv_from_table(params.layers[n_layers - 1 - l], h[:m], h[m:],
                            ids, nb_per_level[l], mode="dma")
    return head_apply(params, h)


def pinsage_forward(params: PinSageParams, features: torch.Tensor,
                    nbhd_weights: torch.Tensor, nbhd_nodes: torch.Tensor,
                    nodeset: torch.Tensor, n_layers: int, T: int
                    ) -> torch.Tensor:
    """Embed ``nodeset`` rows [B] -> [B, out_dim] through the frontier
    path, neighborhoods read from the packed top-T table."""
    return forward_with_gather(
        params, lambda ids: features[ids.long()],
        packed_nbhd_gather(pack_nbhds(nbhd_weights, nbhd_nodes, T), T),
        nodeset, n_layers, T)


def fullgraph_embeddings(params: PinSageParams, features: torch.Tensor,
                         nbhd_weights: torch.Tensor,
                         nbhd_nodes: torch.Tensor, n_layers: int, T: int,
                         block_rows: int = 131_072) -> torch.Tensor:
    """Pre-head activations for ALL items, one dense sweep per layer.

    Layer l's activation of node v does not depend on the batch, so each
    layer runs once over the catalog: on the GPU K2 projects every row of
    the previous layer once, then gathers the nodes in blocks of
    ``block_rows`` (the plain version gathers and projects block by
    block, bounding its [block, T, Din] gather).  Each layer's f32 output
    is stored back in the features' dtype, so under bf16 or f16 every
    layer aggregates a 16-bit table (the JAX package's
    ``store_dtype``)."""
    nb_w = nbhd_weights[:, :T].contiguous()
    nb_n = nbhd_nodes[:, :T].to(torch.int32).contiguous()
    h = features
    for l in range(n_layers):
        h = conv_from_table(params.layers[l], h, h, nb_n, nb_w,
                            block_rows=block_rows)
        if h.dtype != features.dtype:
            h = h.to(features.dtype)
    return h


def pinsage_forward_fullgraph(params: PinSageParams, features: torch.Tensor,
                              nbhd_weights: torch.Tensor,
                              nbhd_nodes: torch.Tensor, nodeset: torch.Tensor,
                              n_layers: int, T: int) -> torch.Tensor:
    """``pinsage_forward`` computed through a full-catalog sweep (same
    math; cheaper once ``nodeset``'s frontier outgrows the catalog)."""
    h = fullgraph_embeddings(params, features, nbhd_weights, nbhd_nodes,
                             n_layers, T)
    return head_apply(params, h[nodeset.long()])


def fullgraph_wins(batch_rows: int, n_items: int, n_layers: int,
                   T: int) -> bool:
    """Feature-row cost model behind ``train.fullgraph_forward="auto"``:
    the frontier forward gathers batch_rows*(T+1)^L feature rows, the
    full-graph sweep touches N*(T+1) rows per layer (the JAX package's
    rule, which matched its measured winner at every batch size)."""
    frontier_rows = batch_rows * (T + 1) ** n_layers
    return frontier_rows > n_items * (T + 1) * n_layers


def embed_all(params: PinSageParams, features: torch.Tensor,
              nbhd_weights: torch.Tensor, nbhd_nodes: torch.Tensor,
              n_items: int, n_layers: int, T: int, batch_size: int = 1024,
              strategy: str = "fullgraph", block_rows: int = 131_072
              ) -> torch.Tensor:
    """Embed every item -> [n_items, out_dim].

    strategy="fullgraph" (default): the full-catalog conv sweep (K2 on the
    GPU, nodes gathered ``block_rows`` at a time), then the head.
    strategy="blocks": the frontier forward (K3 on the GPU) over
    consecutive blocks of ``batch_size`` items, ids wrapping
    modulo the catalog as in the JAX package (whose ``blocks_per_call``
    groups blocks per device dispatch; eager PyTorch launches block by
    block)."""
    if strategy not in ("fullgraph", "blocks"):
        raise ValueError(f"strategy must be 'fullgraph' or 'blocks', got "
                         f"{strategy!r}")
    with torch.inference_mode():
        if strategy == "fullgraph":
            h = fullgraph_embeddings(params, features, nbhd_weights,
                                     nbhd_nodes, n_layers, T, block_rows)
            return head_apply(params, h)[:n_items]
        offsets = torch.arange(batch_size, device=features.device)
        gather_nbhds = packed_nbhd_gather(
            pack_nbhds(nbhd_weights, nbhd_nodes, T), T)
        return torch.cat([
            forward_with_gather(params, lambda ids: features[ids.long()],
                                gather_nbhds, (start + offsets) % n_items,
                                n_layers, T)
            for start in range(0, n_items, batch_size)])[:n_items]
