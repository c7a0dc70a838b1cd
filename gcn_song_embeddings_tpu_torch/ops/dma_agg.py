"""K3: the aggregation of K2 with its gathered rows copied by explicit
row copies (TMA bulk copies) into a two-stage shared-memory ring.

Same function as ``ops.agg`` (K2); only the schedule differs: the next
piece of work's rows are in flight while the current one multiplies.
Its plain version is ``ops.agg.conv_aggregate_plain``.  It is reached
through ``ops.agg.conv_aggregate(..., mode="dma")``, which checks the
tensors (device, dtype, shape, contiguity, alignment) before ``launch``
is called; the frontier forward of the train step runs on it.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_song_embeddings_tpu_torch.ops import cuda_build

NAME = "dma_agg"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/dma_agg.cu"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_agg.py:148"

launches = 0  # kernel launches (not plain-version calls) since the last reset

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def launch(h: torch.Tensor, nb_nodes: torch.Tensor, nb_weights: torch.Tensor,
           wq_t: torch.Tensor, bq: torch.Tensor, out: torch.Tensor) -> None:
    """Launch K3 on checked CUDA tensors: h [N, Din], nb_nodes [B, T]
    int32, nb_weights [B, T], wq_t = Wq^T [Din, H], bq [H] -> out [B, H]
    (all f32 but the ids, contiguous, h and wq_t 16-byte aligned)."""
    global launches
    b, t = nb_nodes.shape
    lib = cuda_build.bind(NAME, _ARGTYPES)
    dev = h.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dma_agg_launch(h.data_ptr(), nb_nodes.data_ptr(),
                                 nb_weights.data_ptr(), wq_t.data_ptr(),
                                 bq.data_ptr(), out.data_ptr(), b, t,
                                 h.shape[1], wq_t.shape[1], stream)
    cuda_build.check(lib, NAME, err)
    launches += 1
