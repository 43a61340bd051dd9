"""Rigid-body transforms on padded coordinate sets (device side).

Capability parity with the reference's CoordsTransform ops
[U: TorchProteinLibrary/Layers/FullAtomModel/CoordsTransform — mount
empty, unverified]: batched translate / rotate / center / bbox and
uniform random rotations.  The reference implements these as C++
autograd Functions; here they are two-line ``jnp`` expressions that XLA
fuses into neighboring kernels, with masking for padded atoms.

Conventions:
* coordinates are ``[..., N, 3]`` float32, row vectors;
* a rotation ``R`` acts as ``x -> x @ R.T`` (i.e. column-vector ``R x``);
* a pose ``(R, t)`` acts about the ligand center of mass: the framework
  always centers structures first, so ``apply_pose(x, R, t) = x @ R.T + t``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.numerics import precision_for


def rotate(coords: jax.Array, R: jax.Array) -> jax.Array:
    """Rotate ``[..., N, 3]`` coords by ``[..., 3, 3]`` rotations."""
    return jnp.einsum("...ij,...nj->...ni", R, coords,
                      precision=precision_for())


def translate(coords: jax.Array, t: jax.Array) -> jax.Array:
    return coords + t[..., None, :]


def apply_pose(coords: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """Rigid pose: rotate about the origin then translate."""
    return rotate(coords, R) + t[..., None, :]


def center_of_mass(coords: jax.Array, mask: jax.Array | None = None) -> jax.Array:
    """Mean position over real atoms; ``mask`` is ``[..., N]`` bool/float."""
    if mask is None:
        return coords.mean(axis=-2)
    w = mask.astype(coords.dtype)[..., None]
    return (coords * w).sum(axis=-2) / jnp.maximum(w.sum(axis=-2), 1.0)


def bounding_box(coords: jax.Array, mask: jax.Array | None = None):
    """(min, max) corners over real atoms."""
    if mask is None:
        return coords.min(axis=-2), coords.max(axis=-2)
    big = jnp.asarray(jnp.inf, coords.dtype)
    m = mask.astype(bool)[..., None]
    lo = jnp.where(m, coords, big).min(axis=-2)
    hi = jnp.where(m, coords, -big).max(axis=-2)
    return lo, hi


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion(s) ``[..., 4]`` (w, x, y, z) -> rotation ``[..., 3, 3]``."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = (q[..., i] for i in range(4))
    row = lambda *e: jnp.stack(e, axis=-1)
    return jnp.stack([
        row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        row(2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ], axis=-2)


def random_rotations(key: jax.Array, n: int) -> jax.Array:
    """``n`` rotations uniform on SO(3) via Gaussian quaternions.

    Replaces the reference's ``getRandomRotation`` [U: CoordsTransform].
    """
    q = jax.random.normal(key, (n, 4))
    return quat_to_matrix(q)


def axis_angle_to_matrix(axis: jax.Array, angle: jax.Array) -> jax.Array:
    """Rodrigues formula; ``axis [..., 3]`` need not be normalized."""
    a = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    half = angle / 2.0
    q = jnp.concatenate(
        [jnp.cos(half)[..., None], jnp.sin(half)[..., None] * a], axis=-1)
    return quat_to_matrix(q)
