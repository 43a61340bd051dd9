"""SO(3) rotation sets for exhaustive and local docking sweeps.

The reference ships precomputed near-uniform SO(3) sampling files (a
coarse set and a dense ~10^4 set) and restricts *local* docking to a cone
around the native orientation [U: DeepLocalProteinDocking rotation data;
paper bioRxiv 738690].  Shipping data files is unnecessary here: the
Super-Fibonacci spiral (Alexa, CVPR 2022 — public algorithm) generates a
low-discrepancy SO(3) sample of *any* size in O(n) closed form, so
rotation sets become pure functions of ``n`` — deterministic across
hosts, no I/O, shardable by slicing.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.numerics import precision_for
from deeplocalproteindocking_tpu.structure.transforms import (
    axis_angle_to_matrix, quat_to_matrix,
)

_PHI = float(np.sqrt(2.0))
# Positive real root of x^4 = x + 4 (Super-Fibonacci constant psi).
_PSI = 1.533751168755204288118041


def super_fibonacci_rotations(n: int) -> jax.Array:
    """``[n, 3, 3]`` near-uniform low-discrepancy cover of SO(3)."""
    i = np.arange(n, dtype=np.float64)
    s = i + 0.5
    t = s / n
    d = 2.0 * np.pi * s
    r, big_r = np.sqrt(t), np.sqrt(1.0 - t)
    alpha, beta = d / _PHI, d / _PSI
    q = np.stack([r * np.sin(alpha), r * np.cos(alpha),
                  big_r * np.sin(beta), big_r * np.cos(beta)], axis=-1)
    return quat_to_matrix(jnp.asarray(q, dtype=jnp.float32))


def local_rotations(base: jax.Array, max_angle: float, n: int,
                    key: jax.Array | None = None) -> jax.Array:
    """``n`` rotations within a geodesic cone of ``max_angle`` (radians)
    around ``base`` — the local-docking restriction of the reference.

    Deterministic by default: uses a Fibonacci sphere of axes crossed with
    a low-discrepancy angle schedule; pass ``key`` for a random set.
    Uniform in Haar measure within the cone requires density ∝ sin²(θ/2)
    in the rotation angle θ; we invert that CDF numerically.
    """
    if key is not None:
        key_a, key_t = jax.random.split(key)
        axes = jax.random.normal(key_a, (n, 3))
        u = jax.random.uniform(key_t, (n,))
    else:
        i = np.arange(n, dtype=np.float64)
        ga = np.pi * (3.0 - np.sqrt(5.0))  # golden angle
        z = 1.0 - 2.0 * (i + 0.5) / n
        rho = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        axes = jnp.asarray(np.stack(
            [rho * np.cos(ga * i), rho * np.sin(ga * i), z], axis=-1),
            dtype=jnp.float32)
        u = jnp.asarray((i + 0.5) / n, dtype=jnp.float32)
    # Invert CDF of p(θ) ∝ sin²(θ/2) on [0, max_angle] via a dense table.
    grid = jnp.linspace(0.0, max_angle, 512)
    pdf = jnp.sin(grid / 2.0) ** 2
    cdf = jnp.cumsum(pdf)
    cdf = cdf / cdf[-1]
    angles = jnp.interp(u, cdf, grid)
    local = axis_angle_to_matrix(axes, angles)
    return jnp.einsum("nij,jk->nik", local, base,
                      precision=precision_for())


def geodesic_angle(R1: jax.Array, R2: jax.Array) -> jax.Array:
    """Rotation angle of R1 R2^T — the SO(3) geodesic distance."""
    tr = jnp.einsum("...ij,...ij->...", R1, R2,
                    precision=precision_for())
    cos = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return jnp.arccos(cos)
