"""Rotation-sharded docking sweep over a device mesh.

NEW relative to the single-GPU reference (SURVEY.md §2.3): the SO(3)
rotation set is sharded across the ``rot`` mesh axis with ``shard_map``;
each device runs the same compiled scan sweep (sweep/docker.py) over its
contiguous rotation slice with the receptor spectrum replicated, then
the per-device top-K candidate lists are ``all_gather``-ed and
re-reduced to a replicated global top-K — the only cross-device
communication in the whole sweep (K * n_dev scalars, vs ~10^14 scores
computed).

The ``batch`` mesh axis (multi-complex eval) composes on top via vmap +
sharding of the complex dimension; see evaluation.py.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deeplocalproteindocking_tpu.sweep.docker import DockResult, dock_sweep


def sharded_dock_sweep(mesh: Mesh,
                       rec_rep: jax.Array,
                       lig_rep: jax.Array,
                       rotations: jax.Array,
                       coupling: Optional[jax.Array] = None,
                       *,
                       top_k: int = 32,
                       chunk: int = 8,
                       score_mask: Optional[jax.Array] = None) -> DockResult:
    """Full-sweep dock with rotations sharded over ``mesh`` axis 'rot'.

    Returns a replicated global top-K ``DockResult`` whose ``rot_idx``
    index into the *original* (unpadded) rotation set.
    """
    n_dev = mesh.shape["rot"]
    n_rot = rotations.shape[0]
    # Pad so every shard gets the same rotation count (multiple of chunk
    # too, so the scan shape is uniform); padded entries are identity
    # rotations masked to -inf inside dock_sweep via rot-id bounds.
    per_shard = -(-n_rot // (n_dev * chunk)) * chunk
    pad = per_shard * n_dev - n_rot
    if pad:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=rotations.dtype),
                               (pad, 3, 3))
        rotations = jnp.concatenate([rotations, eye], axis=0)

    def shard_fn(rec, lig, rots, n_valid):
        shard = jax.lax.axis_index("rot")
        base = (shard * per_shard).astype(jnp.int32)
        # Rotations at global index >= n_valid are padding: mask them
        # inside the scan so they can't crowd real candidates out of
        # this shard's local top-K.
        local_valid = jnp.clip(n_valid - base, 0, per_shard)
        res = dock_sweep(rec, lig, rots, coupling, top_k=top_k,
                         chunk=chunk, score_mask=score_mask,
                         num_valid=local_valid)
        # Re-index into the global rotation set; kill padded entries.
        rot_idx = res.rot_idx + base
        valid = rot_idx < n_valid
        scores = jnp.where(valid, res.scores, -jnp.inf)
        # Top-K merge: gather each device's K candidates, then an
        # identical local re-top-K on every device (replicated output).
        all_scores = jax.lax.all_gather(scores, "rot").reshape(-1)
        all_rot = jax.lax.all_gather(rot_idx, "rot").reshape(-1)
        all_shift = jax.lax.all_gather(res.shifts, "rot").reshape(-1, 3)
        best, sel = jax.lax.top_k(all_scores, top_k)
        return DockResult(scores=best, rot_idx=all_rot[sel],
                          shifts=all_shift[sel])

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P("rot"), P()),
        out_specs=DockResult(scores=P(), rot_idx=P(), shifts=P()),
        check_vma=False)
    n_valid = jnp.asarray(n_rot, dtype=jnp.int32)
    return mapped(rec_rep, lig_rep, rotations, n_valid)


def sharded_dock_sweep_resplat(mesh: Mesh,
                               H: jax.Array,
                               lig_coords: jax.Array,
                               lig_types: jax.Array,
                               lig_mask: jax.Array,
                               rotations: jax.Array,
                               rep_fn,
                               *,
                               grid_size: int,
                               lig_grid: int,
                               resolution: float,
                               sigma: float,
                               num_types: int,
                               top_k: int = 32,
                               chunk: int = 8,
                               score_mask: Optional[jax.Array] = None,
                               fft_impl: str = "dft",
                               dft_dtype: str = "float32",
                               topk_impl: str = "exact",
                               fft_block: int = 32) -> DockResult:
    """Rotation-sharded resplat sweep (see sweep/resplat.py).

    Same communication pattern as :func:`sharded_dock_sweep`: only the
    per-device top-K candidate lists cross devices.
    """
    from deeplocalproteindocking_tpu.sweep.resplat import (
        dock_sweep_resplat)

    n_dev = mesh.shape["rot"]
    n_rot = rotations.shape[0]
    per_shard = -(-n_rot // (n_dev * chunk)) * chunk
    pad = per_shard * n_dev - n_rot
    if pad:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=rotations.dtype),
                               (pad, 3, 3))
        rotations = jnp.concatenate([rotations, eye], axis=0)

    def shard_fn(H_, lc, lt, lm, rots, n_valid):
        shard = jax.lax.axis_index("rot")
        base = (shard * per_shard).astype(jnp.int32)
        local_valid = jnp.clip(n_valid - base, 0, per_shard)
        res = dock_sweep_resplat(
            H_, lc, lt, lm, rots, rep_fn, grid_size=grid_size,
            lig_grid=lig_grid, resolution=resolution, sigma=sigma,
            num_types=num_types, top_k=top_k, chunk=chunk,
            score_mask=score_mask, num_valid=local_valid,
            fft_impl=fft_impl, dft_dtype=dft_dtype,
            topk_impl=topk_impl, fft_block=fft_block)
        rot_idx = res.rot_idx + base
        valid = rot_idx < n_valid
        scores = jnp.where(valid, res.scores, -jnp.inf)
        all_scores = jax.lax.all_gather(scores, "rot").reshape(-1)
        all_rot = jax.lax.all_gather(rot_idx, "rot").reshape(-1)
        all_shift = jax.lax.all_gather(res.shifts, "rot").reshape(-1, 3)
        best, sel = jax.lax.top_k(all_scores, top_k)
        return DockResult(scores=best, rot_idx=all_rot[sel],
                          shifts=all_shift[sel])

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("rot"), P()),
        out_specs=DockResult(scores=P(), rot_idx=P(), shifts=P()),
        check_vma=False)
    n_valid = jnp.asarray(n_rot, dtype=jnp.int32)
    return mapped(H, lig_coords, lig_types, lig_mask, rotations, n_valid)
