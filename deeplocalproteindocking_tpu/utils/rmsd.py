"""Differentiable RMSD: plain and optimal-superposition (Kabsch).

Capability parity with the reference's ``Coords2RMSD``
[U: TorchProteinLibrary/Layers/RMSD/Coords2RMSD — mount empty,
unverified]: minimum RMSD over rigid superposition via the quaternion
eigen-method (Kearsley/Kabsch), differentiable.

Design: the reference implements the 4x4 eigen-problem and
its gradient in C++/CUDA; in JAX it is ``jnp.linalg.eigh`` on a 4x4 —
autodiff gives the gradient for free, and the op is tiny (runs on
scalar/vector units; never a bottleneck).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.numerics import precision_for


def _masked_center(x, w):
    n = jnp.maximum(w.sum(-1, keepdims=True), 1.0)
    mu = (x * w[..., None]).sum(-2) / n
    return x - mu[..., None, :], n[..., 0]


def rmsd(a: jax.Array, b: jax.Array,
         mask: jax.Array | None = None) -> jax.Array:
    """Plain (no superposition) RMSD between ``[..., N, 3]`` coord sets."""
    if mask is None:
        mask = jnp.ones(a.shape[:-1], dtype=a.dtype)
    w = mask.astype(a.dtype)
    n = jnp.maximum(w.sum(-1), 1.0)
    sq = (jnp.sum((a - b) ** 2, axis=-1) * w).sum(-1) / n
    return jnp.sqrt(jnp.maximum(sq, 0.0))


def _quaternion_matrix(a, b, w):
    """Kearsley 4x4 key matrix from centered weighted coord sets."""
    M = jnp.einsum("...ni,...nj->...ij", a * w[..., None], b,
                   precision=precision_for())               # [...,3,3]
    tr = jnp.trace(M, axis1=-2, axis2=-1)
    A = M - jnp.swapaxes(M, -1, -2)
    d = jnp.stack([A[..., 1, 2], A[..., 2, 0], A[..., 0, 1]], axis=-1)
    S = M + jnp.swapaxes(M, -1, -2)
    I = jnp.eye(3, dtype=M.dtype)
    block = S - tr[..., None, None] * I
    top = jnp.concatenate([tr[..., None, None], d[..., None, :]], axis=-1)
    bot = jnp.concatenate([d[..., :, None], block], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)  # [..., 4, 4]


def kabsch_rmsd(a: jax.Array, b: jax.Array,
                mask: jax.Array | None = None) -> jax.Array:
    """Minimum RMSD over rigid superposition of ``a`` onto ``b``."""
    if mask is None:
        mask = jnp.ones(a.shape[:-1], dtype=a.dtype)
    w = mask.astype(a.dtype)
    ac, n = _masked_center(a, w)
    bc, _ = _masked_center(b, w)
    K = _quaternion_matrix(ac, bc, w)
    lam = jnp.linalg.eigvalsh(K)[..., -1]           # largest eigenvalue
    ga = (jnp.sum(ac * ac, axis=-1) * w).sum(-1)
    gb = (jnp.sum(bc * bc, axis=-1) * w).sum(-1)
    sq = (ga + gb - 2.0 * lam) / n
    return jnp.sqrt(jnp.maximum(sq, 0.0))


def kabsch_rotation(a: jax.Array, b: jax.Array,
                    mask: jax.Array | None = None) -> jax.Array:
    """Optimal rotation aligning centered ``a`` onto centered ``b``."""
    from deeplocalproteindocking_tpu.structure.transforms import quat_to_matrix
    if mask is None:
        mask = jnp.ones(a.shape[:-1], dtype=a.dtype)
    w = mask.astype(a.dtype)
    ac, _ = _masked_center(a, w)
    bc, _ = _masked_center(b, w)
    K = _quaternion_matrix(ac, bc, w)
    _, vecs = jnp.linalg.eigh(K)
    q = vecs[..., -1]                               # (w, x, y, z)
    return quat_to_matrix(q)
