"""K3: the aggregation of K2 as one fused kernel over the gathered rows,
each block owning whole nodes, on the tensor cores in 3xTF32.

Same function as ``ops.agg`` (K2), without K2's projected table: the
gathered rows are staged straight into a shared-memory ring while the
previous chunk multiplies, and the weighted mean is the kernel's
epilogue.  Its plain version is ``ops.agg.conv_aggregate_plain``.  It is
reached through ``ops.agg.conv_aggregate(..., mode="dma")``, which checks
the tensors (device, dtype, shape, contiguity, alignment) and splits Wq
(``ops.agg.split_wq``) before ``launch`` is called; the frontier forward
of the train step runs on it.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_song_embeddings_tpu_torch.ops import cuda_build

NAME = "dma_agg"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/dma_agg.cu"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_agg.py:148"

launches = 0  # kernel launches (not plain-version calls) since the last reset

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def launch(h: torch.Tensor, nb_nodes: torch.Tensor, nb_weights: torch.Tensor,
           big: torch.Tensor, small: torch.Tensor, bq: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch K3 on checked CUDA tensors: h [N, Din], nb_nodes [B, T]
    int32, nb_weights [B, T], Wq's TF32 parts ``big`` and ``small`` from
    ``ops.agg.split_wq``, bq [H] -> out [B, H] (all f32 but the ids,
    contiguous, h 16-byte aligned)."""
    global launches
    b, t = nb_nodes.shape
    lib = cuda_build.bind(NAME, _ARGTYPES)
    dev = h.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dma_agg_launch(h.data_ptr(), nb_nodes.data_ptr(),
                                 nb_weights.data_ptr(), big.data_ptr(),
                                 small.data_ptr(), bq.data_ptr(),
                                 out.data_ptr(), b, t, h.shape[1],
                                 bq.shape[0], stream)
    cuda_build.check(lib, NAME, err)
    launches += 1
