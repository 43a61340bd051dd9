"""Volume rotation about the grid center by trilinear resampling.

Capability parity with the reference's ``VolumeRotation`` grid-resampling
stage [U: TorchProteinLibrary/Volume — mount empty, unverified; the
"rotated-ligand grid resampling" of BASELINE.json: north_star].  The
reference uses a CUDA resampling kernel (affine_grid/grid_sample style);
here the inverse-mapped lattice is sampled with
``jax.scipy.ndimage.map_coordinates`` (order=1), vmapped over channels
and rotations, which XLA lowers to fused gathers.

Design note (SURVEY.md §2.1 N6): for *density* volumes the framework
prefers rotating atom coordinates and re-splatting (exact, no
interpolation smear).  Grid resampling is for rotating CNN
*representation* volumes, which are computed once per ligand and reused
across the ~10^4-rotation sweep.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates

from deeplocalproteindocking_tpu.numerics import precision_for


def _source_lattice(R: jax.Array, L: int) -> jax.Array:
    """Inverse-mapped sample coordinates ``[3, L, L, L]``.

    Output voxel at index x reads the input at ``R^T (x - c) + c`` with
    ``c = (L-1)/2`` (rotation about the geometric grid center), matching
    rotation of the underlying atom coordinates about coordinate 0 when
    the volume was splatted on a zero-centered box.
    """
    c = (L - 1) / 2.0
    ax = jnp.arange(L, dtype=jnp.float32) - c
    gx, gy, gz = jnp.meshgrid(ax, ax, ax, indexing="ij")
    pts = jnp.stack([gx, gy, gz])                     # [3, L, L, L]
    src = jnp.einsum("ij,i...->j...", R, pts,
                     precision=precision_for()) + c   # R^T (x - c) + c
    return src


def rotate_volume(vol: jax.Array, R: jax.Array, *, order: int = 1) -> jax.Array:
    """Rotate ``[L, L, L, C]`` volume by ``R`` about the grid center.

    Implemented as 8 *row* gathers over the flattened ``[L^3, C]``
    volume (one per trilinear corner) rather than per-channel
    ``map_coordinates``: each gather reads a contiguous C-channel row
    instead of C independent scalars.
    """
    if order == 0:
        src = _source_lattice(R, vol.shape[0])
        sample = lambda ch: map_coordinates(ch, list(src), order=0,
                                            mode="constant", cval=0.0)
        return jax.vmap(sample, in_axes=-1, out_axes=-1)(vol)
    return _rotate_trilinear_rows(vol, R)


def _rotate_trilinear_rows(vol: jax.Array, R: jax.Array) -> jax.Array:
    L, C = vol.shape[0], vol.shape[-1]
    src = _source_lattice(R, L).reshape(3, -1)        # [3, L^3]
    f = jnp.floor(src)
    frac = src - f                                    # [3, L^3]
    i0 = f.astype(jnp.int32)
    vol_flat = vol.reshape(L * L * L, C)

    out = jnp.zeros((L * L * L, C), dtype=vol.dtype)
    for dx in (0, 1):
        wx = frac[0] if dx else 1.0 - frac[0]
        ix = i0[0] + dx
        vx = (ix >= 0) & (ix < L)
        for dy in (0, 1):
            wy = frac[1] if dy else 1.0 - frac[1]
            iy = i0[1] + dy
            vy = (iy >= 0) & (iy < L)
            for dz in (0, 1):
                wz = frac[2] if dz else 1.0 - frac[2]
                iz = i0[2] + dz
                vz = (iz >= 0) & (iz < L)
                w = jnp.where(vx & vy & vz, wx * wy * wz, 0.0)
                idx = ((jnp.clip(ix, 0, L - 1) * L
                        + jnp.clip(iy, 0, L - 1)) * L
                       + jnp.clip(iz, 0, L - 1))
                out = out + w[:, None] * jnp.take(vol_flat, idx, axis=0)
    return out.reshape(L, L, L, C)


def rotate_volumes(vol: jax.Array, Rs: jax.Array, *, order: int = 1) -> jax.Array:
    """Rotate one volume by a batch of rotations -> ``[B, L, L, L, C]``."""
    return jax.vmap(lambda R: rotate_volume(vol, R, order=order))(Rs)
