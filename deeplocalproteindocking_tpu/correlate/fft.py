"""Exhaustive FFT translational correlation engine.

Capability parity with the reference's ``VolumeConvolution`` CUDA/cuFFT
extension [U: TorchProteinLibrary/Layers/Volume/VolumeConvolution —
mount empty, unverified]: the docking score of a ligand at *every*
integer translation is computed in one shot via the correlation theorem,

    S(t) = sum_{c,d} A[c,d] * sum_x rec_c(x) * lig_d(x - t)
         = irfftn( sum_d H_d . conj(F[lig]_d) ),   H_d = sum_c A[c,d] F[rec]_c

and gradients flow through it for training (BASELINE.json: north_star
"grads through ... FFT correlator").

Design decisions:

* ``jnp.fft.rfftn`` — XLA lowers it to cuFFT on the GPU; no custom
  backward (XLA differentiates the FFT exactly; a custom VJP would only
  save residual memory and can come later).
* **Receptor spectrum caching with the channel coupling folded in**: the
  reference correlates per channel pair and sums afterwards; here the
  coupled receptor spectrum ``H`` is precomputed once per complex, so the
  per-rotation cost is C forward FFTs + one pointwise contraction + ONE
  inverse FFT — independent of the number of channel pairs.  This is the
  single biggest algorithmic win over the reference formulation.
* Circular (no zero-pad) correlation: protein pairs are boxed so that
  receptor + ligand extents fit within L voxels; correlation index ``i``
  is interpreted as the signed shift ``i`` if ``i < L/2`` else ``i - L``
  (classic FFT-docking convention).  ``translation_mask`` bounds the
  valid shift range for local docking.

Volumes are channels-last ``[L, L, L, C]`` (see grids/voxelize.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.numerics import precision_for

_FFT_AXES = (0, 1, 2)


def receptor_transform(rec_rep: jax.Array,
                       coupling: jax.Array | None = None) -> jax.Array:
    """Precompute the coupled receptor spectrum ``H [L, L, L//2+1, C]``.

    ``coupling`` is the learned channel-coupling matrix ``A [C, C]``
    (None = identity, i.e. plain per-channel shape complementarity).
    Cached once per complex and reused across the whole rotation sweep.
    """
    F_rec = jnp.fft.rfftn(rec_rep, axes=_FFT_AXES)
    if coupling is None:
        return F_rec
    return jnp.einsum("xyzc,cd->xyzd", F_rec,
                      coupling.astype(F_rec.real.dtype),
                      precision=precision_for(F_rec.dtype))


def resolve_engine(fft_impl: str, grid_size: int) -> str:
    """Concrete correlator engine for a config choice.

    The default ``dft`` engine holds full ``L^3`` spectra per rotation;
    above 128^3 the overlap-save block engine (correlate/blockfft.py,
    SURVEY.md §5.7) takes over and keeps peak memory at
    O((block+Ls)^3) instead.  Single source of truth
    for the dispatch used by pipeline.dock/rescore, batched evaluation
    and training/mining (round-3 ADVICE: the auto-dispatch lived only
    in dock(), so the other entry points crashed under
    ``fft_impl='block'``).
    """
    if fft_impl == "dft" and grid_size > 128:
        return "block"
    return fft_impl


def coupled_receptor(rep_rec: jax.Array,
                     coupling: jax.Array | None,
                     fft_impl: str) -> jax.Array:
    """The receptor-side tensor ``H`` each engine consumes.

    Spectral engines take the coupled rfft half-spectrum
    (:func:`receptor_transform`).  The ``block`` engine never forms a
    full-grid spectrum — that is its point — so the coupling (or the
    rank-truncated receptor projection, same einsum) folds into the
    REAL-SPACE receptor rep instead, once per receptor; the score is
    bilinear so either side works, and the receptor side is off the
    per-rotation hot path.
    """
    if fft_impl == "block":
        if coupling is None:
            return rep_rec
        return jnp.einsum("...c,cd->...d", rep_rec,
                          coupling.astype(rep_rec.dtype),
                          precision=precision_for(rep_rec.dtype))
    return receptor_transform(rep_rec, coupling)


def correlate_scores(H: jax.Array, lig_rep: jax.Array) -> jax.Array:
    """Score volume ``[L, L, L]``: S[t] for every circular shift t.

    ``H`` from :func:`receptor_transform`; ``lig_rep [L, L, L, C]``.
    """
    L = lig_rep.shape[0]
    F_lig = jnp.fft.rfftn(lig_rep, axes=_FFT_AXES)
    G = jnp.sum(H * jnp.conj(F_lig), axis=-1)
    return jnp.fft.irfftn(G, s=(L, L, L), axes=_FFT_AXES)


def score_at(H: jax.Array, lig_rep: jax.Array,
             shifts: jax.Array) -> jax.Array:
    """Scores at specific signed integer ``shifts [K, 3]`` (voxels).

    Training path: decoy poses are scored by gathering their translation
    cells out of the full correlation volume so that gradients flow
    through the FFT (SURVEY.md §3.2 option (a)).
    """
    S = correlate_scores(H, lig_rep)
    L = S.shape[0]
    idx = jnp.mod(jnp.round(shifts).astype(jnp.int32), L)
    return S[idx[..., 0], idx[..., 1], idx[..., 2]]


def flat_index_to_shift(flat: jax.Array, L: int) -> jax.Array:
    """Flat argmax/top-k index over ``[L, L, L]`` -> signed shift ``[..., 3]``."""
    iz = flat % L
    iy = (flat // L) % L
    ix = flat // (L * L)
    idx = jnp.stack([ix, iy, iz], axis=-1).astype(jnp.int32)
    return jnp.where(idx <= L // 2, idx, idx - L)


def shift_to_flat_index(shift: jax.Array, L: int) -> jax.Array:
    """Signed shift ``[..., 3]`` -> flat index over ``[L, L, L]``."""
    idx = jnp.mod(shift, L)
    return (idx[..., 0] * L + idx[..., 1]) * L + idx[..., 2]


def translation_mask(L: int, max_shift: int,
                     center: jax.Array | None = None) -> jax.Array:
    """``[L, L, L]`` bool mask of shifts with ``|t_i - c_i| <= max_shift``.

    Local docking restricts translations near a center (e.g. the native
    shift), and the mask also guards the circular-wraparound ambiguity
    when structures are large relative to the box.  ``center`` is a
    signed voxel shift ``[3]`` (default 0).
    """
    i = jnp.arange(L)
    signed = jnp.where(i <= L // 2, i, i - L)
    if center is None:
        center = jnp.zeros(3, dtype=signed.dtype)
    # Circular distance along each axis.
    d = jnp.abs(signed[None, :] - center[:, None])
    d = jnp.minimum(d, L - d)
    ok = d <= max_shift
    return ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
