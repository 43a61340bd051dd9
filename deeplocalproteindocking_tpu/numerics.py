"""Matmul precision of the f32 contractions on the sweep and training path.

On an NVIDIA GPU since Ampere, an f32 dot or convolution at
``Precision.DEFAULT`` may run in TF32 (10-bit mantissa, about three
decimal digits), so an "f32" sweep is not f32 unless each contraction
asks for more.  Every f32 (and complex64) contraction of the splat, the CNN, the DFT
correlator, the channel coupling and the pose geometry passes
:func:`precision_for` at its call.  ``PRECISION`` is the one setting;
the choice and the measurement behind it are recorded in ``PERF.md``
("Bring-up measurements").  bf16 operands keep DEFAULT and accumulate
in f32 through ``preferred_element_type``.

``PRECISION`` is read at trace time, so a measurement that compares
precisions sets it before the first trace of the program it times.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

PRECISION = jax.lax.Precision.HIGHEST


def precision_for(dtype=jnp.float32):
    """Precision for a contraction whose operands have ``dtype``."""
    if jnp.dtype(dtype) in (jnp.float32, jnp.complex64):
        return PRECISION
    return jax.lax.Precision.DEFAULT
