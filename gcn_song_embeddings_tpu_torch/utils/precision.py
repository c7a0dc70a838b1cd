"""The matmul precision policy of the train step and the embed path.

The JAX package reads ``GCN_TPU_MATMUL_PRECISION=<default|high|highest>``
once at import and makes it JAX's default matmul precision
(``gcn_song_embeddings_tpu/__init__.py``).  On the TPU ``default`` runs
each f32 product as one bf16 pass with f32 accumulation, ``high`` as
three (bf16_3x: hi*hi + hi*lo + lo*hi, hi = bf16(x), lo = bf16(x - hi))
and ``highest`` f32-accurately; ranking products stay pinned at HIGHEST
op by op.  The port reads the same variable, with the same three values,
once at import, and keeps the number of bf16 passes of the train step's
and the embed's products in ``PASSES``: 1, 3, or None (f32-accurate).

Unset (or empty) means None, the f32-accurate path every earlier figure
of the port was measured on.  That is a deliberate divergence from JAX
on the TPU, where unset means one pass.  Any other value raises.  The
policy is process-wide; ranking (``ops.knn``, ``evals``, ``serve``, the
ALS normal equations, ``parallel`` serving) never reads it.
"""

from __future__ import annotations

import contextlib
import os

ENV = "GCN_TPU_MATMUL_PRECISION"
PASSES_OF = {"default": 1, "high": 3, "highest": None}


def parse(value: str | None) -> int | None:
    """The bf16 passes a value of ``GCN_TPU_MATMUL_PRECISION`` names:
    ``default`` 1, ``high`` 3, ``highest``, unset or empty None."""
    if not value:
        return None
    if value not in PASSES_OF:
        raise ValueError(f"{ENV} must be one of {sorted(PASSES_OF)}, got "
                         f"{value!r}")
    return PASSES_OF[value]


PASSES = parse(os.environ.get(ENV))


@contextlib.contextmanager
def override(value: str | None):
    """``PASSES`` as ``value`` names it for the body (as if the variable
    held ``value`` at import), then as it was."""
    global PASSES
    before, PASSES = PASSES, parse(value)
    try:
        yield PASSES
    finally:
        PASSES = before
