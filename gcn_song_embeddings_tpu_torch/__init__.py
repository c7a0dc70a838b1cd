"""PyTorch/CUDA port of gcn_song_embeddings_tpu for NVIDIA Hopper.

The package mirrors the JAX package's module paths (``config``,
``data.graph``, ``ops.ppr``, ``models.pinsage``, ``serve`` ...) so each
counterpart is easy to find.  It imports ``torch`` and never ``jax``, and
nothing of the JAX package: what it needs from there it carries as its own
copy.

The four Pallas kernels of the TPU build are hand-written CUDA C++
kernels here (``csrc/``), each beside a plain PyTorch version of the same
function:

* ``ops.walk_kernel.restart_walks`` -- the restart-walk hop (K1);
* ``ops.agg.conv_aggregate`` -- the neighbor gather + Q-MLP +
  importance-weighted mean (K2: every table row projected once, then
  gathered; with ``mode="dma"`` K3, fused over the gathered rows; both
  on the 3xTF32 tensor-core core ``csrc/agg_tc.cuh``);
* ``ops.quant_kernel.quantize_rows_stochastic`` -- the stochastic int8
  row quantizer (K4).

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (see ``utils.device``).
"""
