"""K3: the aggregation of K2 as one fused kernel over the gathered rows,
each block owning whole nodes, on the tensor cores in 3xTF32.

Same function as ``ops.agg`` (K2), without K2's projected table: the
gathered rows are staged straight into a shared-memory ring while the
previous chunk multiplies, and the weighted mean is the kernel's
epilogue.  Its plain version is ``ops.agg.conv_aggregate_plain``.  It is
reached through ``ops.agg.conv_aggregate(..., mode="dma")``, which checks
the tensors (device, dtype, shape, contiguity, alignment) and splits Wq
(``ops.agg.split_wq``) before ``launch`` is called; the frontier forward
of the train step runs on it.  ``launch16`` is its 16-bit form (a bf16
or f16 table and Wq, Wq tiled by ``ops.agg.tile_wq16``) on the 16-bit
core of ``csrc/agg_tc.cuh``: the deepest layer of the frontier forward under ``train.dtype="bfloat16"`` or
``"float16"``, counted in ``launches_bf16`` and ``launches_f16``.
``launch_bf16x`` runs an f32 table in one or three bf16 passes (the
precision policy, ``utils.precision``), Wq tiled by
``ops.agg.tile_wq_bf16x``, counted in ``launches_bf16x1`` and
``launches_bf16x3``.  Every 16-bit form runs the 16-bit core of the same
header: a block pair gathers a pair of row tiles once into shared memory
(an f32 row rounded to bf16, or split into hi and lo, as it is staged)
and sweeps a run of Wq's column tiles over them, each k chunk's partial
sum promoted to an f32 sum; K2's projections run the same core, and
``card_schedule`` asks the card's launch for the grid it picks.

Every launch takes ``slopes``: None, or an int32 tensor [B*T,
``ops.agg.slope_words(H)``] that the epilogue fills with the leaky_relu's
branch of each gathered entry and column (q >= 0, in the accumulator
fragment's layout: ``ops.agg.unpack_slope_bits``), the residual that
``ops.agg.ConvAggregate`` keeps for its backward (``csrc/agg_bwd.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from gcn_song_embeddings_tpu_torch.ops import cuda_build

NAME = "dma_agg"
SOURCE = "gcn_song_embeddings_tpu_torch/csrc/dma_agg.cu"
REPLACES = "gcn_song_embeddings_tpu/ops/pallas_agg.py:148"

launches = 0  # kernel launches (not plain-version calls) since the last reset
launches_bf16 = 0  # the bf16 form's launches since the last reset
launches_f16 = 0  # the f16 form's launches since the last reset
launches_bf16x1 = 0  # an f32 table's one-bf16-pass form's launches
launches_bf16x3 = 0  # an f32 table's three-bf16-pass form's launches

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES16 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGTYPES_BF16X = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])


def _ptr(slopes: torch.Tensor | None) -> int:
    return 0 if slopes is None else slopes.data_ptr()


def card_schedule(kind: str, rows: int, din: int, hdim: int, t: int = 1,
                  passes: int = 1) -> dict:
    """The grid the card's launch takes on the 16-bit core (``choose16``
    in csrc/agg_tc.cuh): ``kind`` "dma" (K3, ``rows`` nodes
    of ``t`` rows) or "project" (K2's projection of ``rows`` table rows),
    ``passes`` 0 (a 16-bit table), 1 or 3 (an f32 table in bf16 passes).
    ``resident``: a row tile's k chunks fit the A slots, so each row is
    read (and rounded) once a run of column tiles, else once a tile;
    ``groups``: the column tiles split into that many equal runs, each
    (row-tile pair, run) one of ``items``; ``clusters``: the block pairs
    the card runs at once; ``blocks``: the persistent grid."""
    lib = cuda_build.library("dma_agg" if kind == "dma" else "agg")
    fn, args = ((lib.dma_agg_schedule, (rows, t, din, hdim, passes))
                if kind == "dma" else
                (lib.agg_project_schedule, (rows, din, hdim, passes)))
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sc = (ctypes.c_int * 5)()
    err = fn(*args, sc)
    if err != 0:
        raise RuntimeError(f"the schedule query failed: CUDA error {err}")
    return dict(zip(("resident", "groups", "items", "clusters", "blocks"),
                    (bool(sc[0]), *sc[1:])))


def launch(h: torch.Tensor, nb_nodes: torch.Tensor, nb_weights: torch.Tensor,
           big: torch.Tensor, small: torch.Tensor, bq: torch.Tensor,
           out: torch.Tensor, slopes: torch.Tensor | None = None) -> None:
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
                                 out.data_ptr(), _ptr(slopes), b, t,
                                 h.shape[1], bq.shape[0], stream)
    cuda_build.check(lib, NAME, err)
    launches += 1


def launch16(h: torch.Tensor, nb_nodes: torch.Tensor,
             nb_weights: torch.Tensor, tiles: torch.Tensor, bq: torch.Tensor,
             out: torch.Tensor, slopes: torch.Tensor | None = None) -> None:
    """Launch K3's 16-bit form on checked CUDA tensors: h [N, Din] bf16 or
    f16 (Din a multiple of 8), nb_nodes [B, T] int32, nb_weights [B, T]
    f32, Wq's tiles (h's type) from ``ops.agg.tile_wq16``, bq [H] f32 ->
    out [B, H] f32 (contiguous, h 16-byte aligned)."""
    global launches_bf16, launches_f16
    b, t = nb_nodes.shape
    f16 = h.dtype == torch.float16
    lib = cuda_build.bind(NAME, _ARGTYPES16, "launch16")
    dev = h.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dma_agg_launch16(h.data_ptr(), nb_nodes.data_ptr(),
                                   nb_weights.data_ptr(), tiles.data_ptr(),
                                   bq.data_ptr(), out.data_ptr(),
                                   _ptr(slopes), b, t, h.shape[1],
                                   bq.shape[0], int(f16), stream)
    cuda_build.check(lib, NAME, err)
    if f16:
        launches_f16 += 1
    else:
        launches_bf16 += 1


def launch_bf16x(h: torch.Tensor, nb_nodes: torch.Tensor,
                 nb_weights: torch.Tensor, hi: torch.Tensor,
                 lo: torch.Tensor | None, bq: torch.Tensor, out: torch.Tensor,
                 passes: int, slopes: torch.Tensor | None = None) -> None:
    """Launch K3 on an f32 table in ``passes`` (1 or 3) bf16 passes, on
    checked CUDA tensors: h [N, Din] f32 (Din a multiple of 8),
    nb_nodes [B, T] int32, nb_weights [B, T] f32, Wq's bf16 tiles ``hi``
    (and ``lo`` for three passes) from ``ops.agg.tile_wq_bf16x``, bq [H]
    f32 -> out [B, H] f32 (contiguous, h 16-byte aligned)."""
    global launches_bf16x1, launches_bf16x3
    b, t = nb_nodes.shape
    lib = cuda_build.bind(NAME, _ARGTYPES_BF16X, "launch_bf16x")
    dev = h.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dma_agg_launch_bf16x(
            h.data_ptr(), nb_nodes.data_ptr(), nb_weights.data_ptr(),
            hi.data_ptr(), 0 if lo is None else lo.data_ptr(),
            bq.data_ptr(), out.data_ptr(), _ptr(slopes), b, t, h.shape[1],
            bq.shape[0], passes, stream)
    cuda_build.check(lib, NAME, err)
    if passes == 1:
        launches_bf16x1 += 1
    else:
        launches_bf16x3 += 1
