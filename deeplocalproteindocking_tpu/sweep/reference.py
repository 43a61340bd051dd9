"""Plain reference for the resplat sweep, and the check against it.

The reference scores every rotation with the textbook correlation: the
ligand representation is embedded into the full grid and correlated
with the receptor spectrum by ``jnp.fft`` (``correlate_scores``), in f32
under ``jax.default_matmul_precision("highest")``, and the global top-K
is an exact ``lax.top_k``.  It shares only the representation (splat +
CNN) with the sweep under test, so a disagreement points at the
correlator engine, the top-K or the precision of the sweep's
contractions.

:func:`topk_agreement` states the tolerance: the candidate's top-K
``(rotation, shift)`` set equals the reference's, except swaps between
entries whose reference scores differ by less than ``tol``, and every
candidate score is within ``tol`` of the reference score of its pose.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.correlate.fft import (
    correlate_scores, flat_index_to_shift, shift_to_flat_index,
)
from deeplocalproteindocking_tpu.grids.voxelize import separable_splat
from deeplocalproteindocking_tpu.sweep.docker import DockResult


def reference_sweep(H: jax.Array, lig_coords: jax.Array,
                    lig_types: jax.Array, lig_mask: jax.Array,
                    rotations: jax.Array, rep_fn: Callable, *,
                    grid_size: int, lig_grid: int, resolution: float,
                    sigma: float, num_types: int, top_k: int,
                    score_mask: Optional[jax.Array] = None,
                    chunk: int = 8):
    """``(DockResult, max|S|, score_at)``: exact top-K over all
    rotations x translations, the largest score magnitude seen (the
    scale of the tolerance), and ``score_at(rot, shift)``, the
    reference score of any one pose.  ``H`` is the coupled receptor
    half-spectrum."""
    L, n_rot = grid_size, rotations.shape[0]
    pad = (-n_rot) % chunk
    rots = jnp.concatenate(
        [rotations, jnp.broadcast_to(jnp.eye(3), (pad, 3, 3))])
    off = (L - lig_grid) // 2
    keep = min(top_k, L ** 3)

    def scores(Rc):
        coords = jnp.einsum("bij,nj->bni", Rc, lig_coords)
        vols = jax.vmap(lambda c: separable_splat(
            c, lig_types, lig_mask, grid_size=lig_grid,
            resolution=resolution, sigma=sigma,
            num_types=num_types))(coords)
        reps = rep_fn(vols)
        big = jnp.pad(reps, [(0, 0)] + [(off, L - lig_grid - off)] * 3
                      + [(0, 0)])
        S = jax.vmap(lambda v: correlate_scores(H, v))(big)
        if score_mask is not None:
            S = jnp.where(score_mask[None], S, -jnp.inf)
        return S.reshape(Rc.shape[0], -1)

    scores_jit = jax.jit(scores)

    def score_at(r: int, shift) -> float:
        with jax.default_matmul_precision("highest"):
            S = scores_jit(rotations[r][None])[0]
        return float(S[shift_to_flat_index(jnp.asarray(shift), L)])

    @jax.jit
    def step(carry, Rc_base):
        best, rot, flat, smax = carry
        Rc, base = Rc_base
        S = scores(Rc)
        valid = base + jnp.arange(chunk) < n_rot
        S = jnp.where(valid[:, None], S, -jnp.inf)
        smax = jnp.maximum(smax, jnp.max(jnp.where(
            jnp.isfinite(S), jnp.abs(S), 0.0)))
        v, f = jax.lax.top_k(S, keep)                     # per rotation
        r = jnp.broadcast_to((base + jnp.arange(chunk))[:, None], v.shape)
        allv = jnp.concatenate([best, v.reshape(-1)])
        sel = jax.lax.top_k(allv, keep)[1]
        return (allv[sel], jnp.concatenate([rot, r.reshape(-1)])[sel],
                jnp.concatenate([flat, f.reshape(-1)])[sel], smax)

    with jax.default_matmul_precision("highest"):
        carry = (jnp.full((keep,), -jnp.inf), jnp.zeros((keep,), jnp.int32),
                 jnp.zeros((keep,), jnp.int32), jnp.zeros(()))
        for i in range(rots.shape[0] // chunk):
            carry = step(carry, (rots[i * chunk:(i + 1) * chunk],
                                 jnp.int32(i * chunk)))
    best, rot, flat, smax = carry
    return (DockResult(scores=best, rot_idx=rot,
                       shifts=flat_index_to_shift(flat, L)),
            float(smax), score_at)


def _poses(res) -> list:
    return [(int(r), tuple(int(v) for v in s))
            for r, s in zip(np.asarray(res.rot_idx),
                            np.asarray(res.shifts))]


def topk_agreement(ref: DockResult, cand: DockResult, tol: float,
                   ref_score_at: Callable) -> dict:
    """Compare a candidate top-K with the reference top-K (see module
    docstring).  ``ref_score_at(rot, shift)`` gives the reference score
    of a candidate pose outside the reference's top-K.  Returns ``ok``
    plus the numbers behind it."""
    rs = np.asarray(ref.scores, np.float64)
    cs = np.asarray(cand.scores, np.float64)
    ref_of = dict(zip(_poses(ref), rs))
    cand_poses = _poses(cand)
    cand_ref = np.asarray([ref_of[p] if p in ref_of else ref_score_at(*p)
                           for p in cand_poses])
    in_cand = set(cand_poses)
    missing = [ref_of[p] for p in ref_of if p not in in_cand]
    extra = [s for p, s in zip(cand_poses, cand_ref) if p not in ref_of]
    swap_gap = (max(missing) - min(extra)) if missing else 0.0
    score_err = float(np.max(np.abs(cs - cand_ref))) if len(cs) else 0.0
    return dict(ok=bool(swap_gap < tol and score_err <= tol),
                swaps=len(missing), swap_gap=float(swap_gap),
                max_score_err=score_err, tol=float(tol),
                top1_same=bool(cand_poses[:1] == _poses(ref)[:1]),
                top10_overlap=len(set(cand_poses[:10])
                                  & set(_poses(ref)[:10])))
