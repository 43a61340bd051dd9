"""Resplat sweep: gather-free rotation via coordinate re-splatting.

The reference rotates the ligand's *representation volume* per rotation
(CUDA grid resample) because recomputing the representation per rotation
was too expensive on a 2019 GPU [U: DeepLocalProteinDocking/Models/
EQDockerGPU.py — mount empty, unverified].  Trilinear resampling is a
gather per voxel, while dense contractions run on the matrix units, so
this hot loop rotates the ligand *atom coordinates* (exact, 9
FLOPs/atom), re-splats on a small ligand-sized box with the matmul-form
separable splat, and re-runs the small 3D CNN:

    per rotation R:
        coords_R = R @ lig_coords                 # exact rotation
        vol_R    = separable_splat(coords_R)      # one contraction
        rep_R    = rep_fn(vol_R)                  # 3D CNN on Ls^3 box
        S        = irfftn( sum_d H_d conj(F[embed(rep_R)]_d) )
        streaming top-K

Two wins besides speed: the rotated density is *exact* (no trilinear
interpolation smear), and score(R, t) is genuinely the score of the
rotated ligand — the reference's rep-rotation is an equivariance
approximation of this quantity.  The ligand box ``Ls`` only needs to
cover the ligand + CNN receptive field, so the CNN runs on ``Ls^3``
(typically 8-64x fewer voxels than the full grid).

The resample path (grids/rotate.py) remains available as
``sweep_mode="resample"`` for reference-fidelity comparisons.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.correlate.dft import get_correlator
from deeplocalproteindocking_tpu.correlate.fft import (
    correlate_scores, flat_index_to_shift,
)
from deeplocalproteindocking_tpu.grids.voxelize import separable_splat
from deeplocalproteindocking_tpu.numerics import precision_for
from deeplocalproteindocking_tpu.sweep.docker import DockResult
from deeplocalproteindocking_tpu.sweep.topk import exact_block_topk


def auto_ligand_grid(lig_coords: np.ndarray, resolution: float,
                     sigma: float, receptive_field: int,
                     grid_size: int) -> int:
    """Smallest even ligand box covering atoms + splat tails + CNN RF.

    The sweep ROTATES the ligand inside this box, so containment must
    be rotation-invariant: every rotated atom Gaussian fits iff
    ``Ls * res / 2 >= max ||x||_2 + 3 sigma`` (the L2 radius, not the
    per-axis max of one orientation — a diagonal-extended ligand can
    swing past the per-axis bound under rotation and silently lose
    splat density).  The per-axis formula plus its RF/rounding slack
    already satisfies this for globular ligands (measured: 0/48
    held-out complexes violate), so the floor only engages for
    elongated ones.
    """
    xyz = np.asarray(lig_coords)
    extent = 2.0 * (np.abs(xyz).max() + 3.0 * sigma)
    ls = int(np.ceil(extent / resolution)) + 2 * receptive_field
    radius = float(np.sqrt((xyz * xyz).sum(axis=1).max()))
    ls_contain = int(np.ceil(2.0 * (radius + 3.0 * sigma) / resolution))
    ls = min(grid_size, ((max(ls, ls_contain) + 7) // 8) * 8)
    return max(ls, 16)


def embed_small(rep_small: jax.Array, grid_size: int) -> jax.Array:
    """Center a ``[..., Ls, Ls, Ls, C]`` rep in the ``grid_size`` box.

    Both boxes are centered on coordinate 0, so small voxel j maps to
    big voxel ``j + (L - Ls)//2`` exactly (L, Ls even).
    """
    Ls = rep_small.shape[-2]
    off = (grid_size - Ls) // 2
    pad = [(0, 0)] * (rep_small.ndim - 4) + [
        (off, grid_size - Ls - off)] * 3 + [(0, 0)]
    return jnp.pad(rep_small, pad)


@functools.partial(
    jax.jit,
    static_argnames=("rep_fn", "grid_size", "lig_grid", "resolution",
                     "sigma", "num_types", "top_k", "chunk", "fft_impl",
                     "dft_dtype", "topk_impl", "fft_block"),
)
def dock_sweep_resplat(H: jax.Array,
                       lig_coords: jax.Array,
                       lig_types: jax.Array,
                       lig_mask: jax.Array,
                       rotations: jax.Array,
                       rep_fn: Callable[[jax.Array], jax.Array],
                       *,
                       grid_size: int,
                       lig_grid: int,
                       resolution: float,
                       sigma: float,
                       num_types: int,
                       top_k: int = 32,
                       chunk: int = 8,
                       score_mask: Optional[jax.Array] = None,
                       num_valid: Optional[jax.Array] = None,
                       fft_impl: str = "dft",
                       dft_dtype: str = "float32",
                       topk_impl: str = "exact",
                       fft_block: int = 32) -> DockResult:
    """Full rotation sweep with per-rotation coordinate re-splatting.

    ``H`` is the coupled receptor spectrum (correlate/fft.py);
    ``rep_fn`` maps a batch of density volumes ``[B, Ls, Ls, Ls, T]`` to
    representations ``[B, Ls, Ls, Ls, C]`` (the CNN, or the analytic
    shape channels).
    """
    L = grid_size
    n_rot = rotations.shape[0]
    if topk_impl == "approx":
        import warnings
        warnings.warn(
            "topk_impl='approx' trades per-rotation top-K set recall "
            "(measured 43/64 on near-tied shape scores, DESIGN.md) for "
            "speed; top-1 is preserved but top-10 hit-rates can "
            "silently change. Use the default 'exact' for reported "
            "results.", stacklevel=2)
    if num_valid is None:
        num_valid = jnp.asarray(n_rot, dtype=jnp.int32)

    pad = (-n_rot) % chunk
    if pad:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=rotations.dtype),
                               (pad, 3, 3))
        rotations = jnp.concatenate([rotations, eye], axis=0)
    n_steps = rotations.shape[0] // chunk
    rot_chunks = rotations.reshape(n_steps, chunk, 3, 3)
    base_ids = jnp.arange(n_steps, dtype=jnp.int32) * chunk
    neg_inf = jnp.array(-jnp.inf, dtype=jnp.float32)

    def splat_one(coords_r):
        return separable_splat(coords_r, lig_types, lig_mask,
                               grid_size=lig_grid, resolution=resolution,
                               sigma=sigma, num_types=num_types)

    def step(carry, inp):
        c_scores, c_rot, c_flat = carry
        Rc, base = inp
        with jax.named_scope("rotate_coords_resplat"):
            coords_r = jnp.einsum("bij,nj->bni", Rc, lig_coords,
                                  precision=precision_for())
            vols = jax.vmap(splat_one)(coords_r)     # [chunk,Ls,Ls,Ls,T]
        with jax.named_scope("ligand_cnn"):
            reps = rep_fn(vols)                      # [chunk,Ls,Ls,Ls,C]
        with jax.named_scope("fft_correlate"):
            S = _correlate_batch(H, reps, L, fft_impl, dft_dtype,
                                 fft_block)
        if score_mask is not None:
            S = jnp.where(score_mask[None], S, neg_inf)
        Sf = S.reshape(chunk, L * L * L)
        with jax.named_scope("streaming_topk"):
            if topk_impl == "approx":
                # Approximate top-k; candidates re-merge exactly below.
                vals, flat = jax.lax.approx_max_k(Sf, top_k)
            else:
                # Exact two-stage block top-k (sweep/topk.py): same
                # value multiset as lax.top_k.
                vals, flat = exact_block_topk(Sf, top_k)
        rot_ids = base + jnp.arange(chunk, dtype=jnp.int32)
        valid = rot_ids < num_valid
        vals = jnp.where(valid[:, None], vals, neg_inf)
        rot_ids = jnp.broadcast_to(rot_ids[:, None], vals.shape)

        all_scores = jnp.concatenate([c_scores, vals.reshape(-1)])
        all_rot = jnp.concatenate([c_rot, rot_ids.reshape(-1)])
        all_flat = jnp.concatenate(
            [c_flat, flat.reshape(-1).astype(jnp.int32)])
        best, sel = jax.lax.top_k(all_scores, top_k)
        return (best, all_rot[sel], all_flat[sel]), None

    init = (jnp.full((top_k,), -jnp.inf, dtype=jnp.float32),
            jnp.zeros((top_k,), dtype=jnp.int32),
            jnp.zeros((top_k,), dtype=jnp.int32))
    (scores, rot_idx, flat_idx), _ = jax.lax.scan(
        step, init, (rot_chunks, base_ids))
    return DockResult(scores=scores, rot_idx=rot_idx,
                      shifts=flat_index_to_shift(flat_idx, L))


def _correlate_batch(H, reps, grid_size, fft_impl, dft_dtype,
                     fft_block=32):
    """Score volumes ``[B, L, L, L]`` for small-box reps (any engine)."""
    if fft_impl == "block":
        # Overlap-save block decomposition (correlate/blockfft.py,
        # SURVEY.md §5.7): H here is the RAW real-space receptor rep
        # [L, L, L, C] (no full-grid spectrum is ever formed — that is
        # the point); the channel coupling is folded into the ligand
        # reps upstream (pipeline.dock).
        from deeplocalproteindocking_tpu.correlate.blockfft import (
            block_correlate_scores)
        return jax.vmap(
            lambda r: block_correlate_scores(H, r, None,
                                             block=fft_block))(reps)
    if fft_impl == "dft":
        corr = get_correlator(grid_size, reps.shape[-2], dft_dtype)
        return corr.scores(H.real.astype(jnp.float32),
                           H.imag.astype(jnp.float32), reps)
    big = embed_small(reps, grid_size)
    return jax.vmap(lambda v: correlate_scores(H, v))(big)


def score_decoys_resplat(H: jax.Array,
                         lig_coords: jax.Array,
                         lig_types: jax.Array,
                         lig_mask: jax.Array,
                         rotations: jax.Array,
                         shifts: jax.Array,
                         rep_fn: Callable[[jax.Array], jax.Array],
                         *,
                         grid_size: int,
                         lig_grid: int,
                         resolution: float,
                         sigma: float,
                         num_types: int,
                         fft_impl: str = "dft",
                         dft_dtype: str = "float32",
                         fft_block: int = 32) -> jax.Array:
    """Training path: scores of specific decoy poses ``(R_i, shift_i)``.

    Same model definition as the sweep (rotate coords -> splat -> CNN ->
    FFT gather), so training and docking share one scoring function and
    gradients genuinely flow through the voxelizer
    (BASELINE.json: north_star).  Sequential ``lax.map`` + remat keeps
    reverse-mode memory at one decoy.
    """
    if fft_impl == "dft":
        # Single-pose scores need no inverse transform at all: evaluate
        # S(t) = sum_k G[k] exp(+2 pi i k.t / L) by three small phase
        # contractions (sweep/refine.py) — ~2x cheaper per decoy than
        # materializing the full score volume and gathering one cell.
        from deeplocalproteindocking_tpu.sweep.refine import (
            continuous_score)

        @jax.checkpoint
        def score_one(args):
            R, sh = args
            return continuous_score(
                H, lig_coords, lig_types, lig_mask, R,
                sh.astype(jnp.float32), rep_fn, grid_size=grid_size,
                lig_grid=lig_grid, resolution=resolution, sigma=sigma,
                num_types=num_types)

        return jax.lax.map(score_one, (rotations, shifts))

    @jax.checkpoint
    def score_one(args):
        R, s = args
        coords_r = jnp.einsum("ij,nj->ni", R, lig_coords,
                              precision=precision_for())
        vol = separable_splat(coords_r, lig_types, lig_mask,
                              grid_size=lig_grid, resolution=resolution,
                              sigma=sigma, num_types=num_types)
        rep = rep_fn(vol[None])
        S = _correlate_batch(H, rep, grid_size, fft_impl, dft_dtype,
                             fft_block)[0]
        # Lattice gather: shifts may be float (augmented mined decoys).
        idx = jnp.mod(jnp.round(s).astype(jnp.int32), grid_size)
        return S[idx[0], idx[1], idx[2]]

    return jax.lax.map(score_one, (rotations, shifts))
