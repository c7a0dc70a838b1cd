"""The matmul precision policy of the train step and the embed path.

The JAX package reads ``GCN_TPU_MATMUL_PRECISION`` once at import and
hands it unchanged to ``jax.config.update("jax_default_matmul_precision",
...)`` (``gcn_song_embeddings_tpu/__init__.py``).  On the TPU ``default``
(alias ``bfloat16``, preset ``BF16_BF16_F32``) runs each f32 product as
one bf16 pass with f32 accumulation, ``high`` (``tensorfloat32``,
``BF16_BF16_F32_X3``) as three (bf16_3x: hi*hi + hi*lo + lo*hi, hi =
bf16(x), lo = bf16(x - hi)) and ``highest`` (``float32``,
``F32_F32_F32``) f32-accurately; ranking products stay pinned at HIGHEST
op by op.  The port reads the same variable once at import and keeps
the number of bf16 passes of the train step's and the embed's products
in ``PASSES``: 1, 3, or None (f32-accurate).

Unset (or empty) means None, the f32-accurate path every earlier figure
of the port was measured on.  That is a deliberate divergence from JAX
on the TPU, where unset means one pass.  So is ``UNFORMED``: presets
JAX accepts that name another algorithm (six or nine bf16 passes, TF32,
f16 or f8 operands, bf16 or f64 sums), for which the port has no form;
they raise, as does any value JAX refuses.  The policy is process-wide;
ranking (``ops.knn``, ``evals``, ``serve``, the ALS normal equations,
``parallel`` serving) never reads it.
"""

from __future__ import annotations

import contextlib
import os

ENV = "GCN_TPU_MATMUL_PRECISION"
PASSES_OF = {
    "default": 1, "high": 3, "highest": None,            # JAX's levels
    "bfloat16": 1, "tensorfloat32": 3, "float32": None,  # their aliases
    "BF16_BF16_F32": 1, "BF16_BF16_F32_X3": 3, "F32_F32_F32": None,
}
# the dot algorithm presets JAX accepts whose arithmetic no form of the
# port's runs: refused, a deliberate divergence
UNFORMED = (
    "ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY",
    "ANY_F8_ANY_F8_ANY_FAST_ACCUM", "F16_F16_F16", "F16_F16_F32",
    "BF16_BF16_BF16", "BF16_BF16_F32_X6", "BF16_BF16_F32_X9",
    "TF32_TF32_F32", "TF32_TF32_F32_X3", "F64_F64_F64",
)


def parse(value: str | None) -> int | None:
    """The bf16 passes a value of ``GCN_TPU_MATMUL_PRECISION`` names
    (``PASSES_OF``: 1, 3 or None; unset or empty None)."""
    if not value:
        return None
    if value in UNFORMED:
        raise ValueError(
            f"{ENV}={value!r}: JAX accepts this dot algorithm preset, but "
            f"the port runs f32 products only as 1 or 3 bf16 passes or "
            f"f32-accurately, so it refuses {', '.join(UNFORMED)} (a "
            f"deliberate divergence); use one of {list(PASSES_OF)}")
    if value not in PASSES_OF:
        raise ValueError(f"{ENV} must be one of {list(PASSES_OF)}, got "
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
