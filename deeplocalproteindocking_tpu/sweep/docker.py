"""The docking sweep: exhaustive rotation x translation scan.

Capability parity with the reference's docker driver
[U: DeepLocalProteinDocking/Models/EQDockerGPU.py — mount empty,
unverified]: for each rotation in an SO(3) set, rotate the ligand
representation, correlate against the receptor representation over all
translations, and keep the best (rotation, translation, score) poses.

Design (this is the reference-style hot path — SURVEY.md §3.1):

* The reference runs a Python ``for R in rotations`` loop launching CUDA
  kernels per iteration.  Here the whole sweep is ONE compiled
  ``lax.scan`` over rotation chunks; each chunk rotates + correlates a
  batch of rotations with batched FFTs (vmap), so XLA pipelines
  gather -> FFT -> pointwise -> iFFT -> top-k without host round trips.
* **Streaming top-K in the scan carry**: a 13k-rotation x 128^3 sweep
  would materialize ~10^14 scores; instead each chunk reduces to its
  per-rotation top-K immediately after the inverse FFT and merges into a running global top-K.  Memory
  is O(L^3 * chunk), independent of the rotation count.
* The receptor spectrum (with channel coupling folded in) is computed
  once, outside the scan (see correlate/fft.py).

Multi-chip rotation sharding wraps this same function via ``shard_map``
(parallel/sharded_sweep.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.correlate.fft import (
    correlate_scores, flat_index_to_shift, receptor_transform,
)
from deeplocalproteindocking_tpu.grids.rotate import rotate_volumes


class DockResult(NamedTuple):
    """Top-K ranked rigid-body poses (descending score)."""
    scores: jax.Array      # [K] float32
    rot_idx: jax.Array     # [K] int32 — index into the rotation set
    shifts: jax.Array      # [K, 3] int32 — signed voxel translations

    def translations(self, resolution: float) -> jax.Array:
        """Translations in Angstrom."""
        return self.shifts.astype(jnp.float32) * resolution


@functools.partial(jax.jit, static_argnames=("top_k", "chunk"))
def dock_sweep(rec_rep: jax.Array,
               lig_rep: jax.Array,
               rotations: jax.Array,
               coupling: Optional[jax.Array] = None,
               *,
               top_k: int = 32,
               chunk: int = 8,
               score_mask: Optional[jax.Array] = None,
               num_valid: Optional[jax.Array] = None) -> DockResult:
    """Sweep ``rotations [R, 3, 3]`` over all translations.

    ``rec_rep``/``lig_rep`` are ``[L, L, L, C]`` representation volumes.
    ``score_mask`` (optional ``[L, L, L]`` bool) restricts valid
    translations (local docking / wraparound guard).
    Rotations are padded to a multiple of ``chunk``; padded entries are
    masked to -inf.  ``num_valid`` (optional dynamic scalar) marks
    rotations at index >= num_valid as padding too — used by the sharded
    sweep so externally-padded rotation slices can never crowd real
    candidates out of the local top-K.
    """
    L = rec_rep.shape[0]
    n_rot = rotations.shape[0]
    if num_valid is None:
        num_valid = jnp.asarray(n_rot, dtype=jnp.int32)
    H = receptor_transform(rec_rep, coupling)

    pad = (-n_rot) % chunk
    if pad:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=rotations.dtype),
                               (pad, 3, 3))
        rotations = jnp.concatenate([rotations, eye], axis=0)
    n_steps = rotations.shape[0] // chunk
    rot_chunks = rotations.reshape(n_steps, chunk, 3, 3)
    base_ids = jnp.arange(n_steps, dtype=jnp.int32) * chunk

    neg_inf = jnp.array(-jnp.inf, dtype=jnp.float32)

    def step(carry, inp):
        c_scores, c_rot, c_flat = carry
        Rc, base = inp
        with jax.named_scope("rotate_ligand_rep"):
            lig_rots = rotate_volumes(lig_rep, Rc)          # [chunk,L,L,L,C]
        with jax.named_scope("fft_correlate"):
            S = jax.vmap(lambda v: correlate_scores(H, v))(lig_rots)
        if score_mask is not None:
            S = jnp.where(score_mask[None], S, neg_inf)
        Sf = S.reshape(chunk, L * L * L)
        with jax.named_scope("streaming_topk"):
            vals, flat = jax.lax.top_k(Sf, top_k)           # [chunk, K]
        rot_ids = base + jnp.arange(chunk, dtype=jnp.int32)
        valid = rot_ids < num_valid                         # mask padding
        vals = jnp.where(valid[:, None], vals, neg_inf)
        rot_ids = jnp.broadcast_to(rot_ids[:, None], vals.shape)

        all_scores = jnp.concatenate([c_scores, vals.reshape(-1)])
        all_rot = jnp.concatenate([c_rot, rot_ids.reshape(-1)])
        all_flat = jnp.concatenate([c_flat, flat.reshape(-1).astype(jnp.int32)])
        best, sel = jax.lax.top_k(all_scores, top_k)
        return (best, all_rot[sel], all_flat[sel]), None

    init = (jnp.full((top_k,), -jnp.inf, dtype=jnp.float32),
            jnp.zeros((top_k,), dtype=jnp.int32),
            jnp.zeros((top_k,), dtype=jnp.int32))
    (scores, rot_idx, flat_idx), _ = jax.lax.scan(
        step, init, (rot_chunks, base_ids))
    return DockResult(scores=scores, rot_idx=rot_idx,
                      shifts=flat_index_to_shift(flat_idx, L))
