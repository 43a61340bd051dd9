"""Matmul-DFT correlation engine: the translational FFT as matmuls.

A DFT is a matmul, so this module computes the 3-D transform of the
small ligand box as einsum contractions with precomputed twiddle
matrices, which XLA hands to the GPU's matrix libraries:

* forward, per axis: ``[Ls -> L]`` (x, y) and ``[Ls -> L/2+1]`` (z,
  rfft half-spectrum), complex arithmetic as explicit (re, im) pairs of
  real matmuls;
* the ligand box's centering offset is folded into the twiddle phase
  ``exp(-2 pi i (pos + off) k / L)`` — the zero-padded embed of the
  small box into the big box is NEVER materialized;
* inverse: two full ``[L -> L]`` axis contractions and a final
  real-part contraction against Hermitian-weighted twiddles
  (w = 2 for interior kz, 1 for the self-conjugate kz = 0, L/2 planes).

About 10 GFLOP/rotation of matmuls at 128^3 and C=16, against ~1.9
GFLOP of FFT butterflies; the ``xla`` engine (``jnp.fft``, cuFFT on the
GPU) is the alternative, and ``PERF.md`` records which one is faster
on the card.  Every f32 contraction states its precision
(``numerics.precision_for``).

The receptor spectrum is still computed once per complex with
``jnp.fft`` (off the hot path), then split into (re, im).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.numerics import precision_for


def _twiddle(pos: np.ndarray, freqs: np.ndarray, L: int, sign: float,
             scale: float = 1.0):
    """(re, im) of ``scale * exp(sign * 2 pi i * pos * k / L)``."""
    ang = 2.0 * np.pi * np.outer(pos, freqs) / L
    re = (scale * np.cos(ang)).astype(np.float32)
    im = (sign * scale * np.sin(ang)).astype(np.float32)
    return re, im


class DFTCorrelator:
    """Precomputed twiddle matrices for a (grid_size, lig_grid) pair."""

    def __init__(self, grid_size: int, lig_grid: int,
                 dtype=jnp.float32):
        L, Ls = grid_size, lig_grid
        if L % 2:
            raise ValueError("grid_size must be even")
        self.L, self.Ls = L, Ls
        self.dtype = dtype
        off = (L - Ls) // 2
        pos = np.arange(Ls) + off               # ligand voxel -> big grid
        kf = np.arange(L)                       # full frequency axis
        kh = np.arange(L // 2 + 1)              # rfft half axis
        xs = np.arange(L)

        # Twiddles are stored as host NumPy arrays (NOT jnp): the
        # correlator is lru_cached across traces, and jnp constants
        # created inside one trace would leak tracers into the next.
        # Forward: exp(-2 pi i (pos) k / L), offset folded in.
        self.WxRe, self.WxIm = _twiddle(pos, kf, L, -1.0)
        self.WyRe, self.WyIm = self.WxRe, self.WxIm
        self.WzRe, self.WzIm = _twiddle(pos, kh, L, -1.0)

        # Inverse: exp(+2 pi i k x / L) / L per axis.
        self.UxRe, self.UxIm = _twiddle(kf, xs, L, +1.0, scale=1.0 / L)
        self.UyRe, self.UyIm = self.UxRe, self.UxIm
        # Final z axis: Hermitian weights fold the missing half-spectrum.
        w = np.full(L // 2 + 1, 2.0)
        w[0] = 1.0
        w[-1] = 1.0
        mzre, mzim = _twiddle(kh, xs, L, +1.0, scale=1.0 / L)
        self.MzRe = mzre * w[:, None]
        self.MzIm = mzim * w[:, None]

    def _cast(self, *xs):
        return tuple(jnp.asarray(x).astype(self.dtype) for x in xs)

    def ligand_spectrum(self, vols: jax.Array):
        """``[B, Ls, Ls, Ls, C]`` real -> spectrum (re, im) each
        ``[B, L, L, L//2+1, C]`` — as if the small box were centered in
        the big box (offset folded into the twiddles)."""
        f32 = jnp.float32
        prec = precision_for(self.dtype)
        v = vols.astype(self.dtype)
        WzRe, WzIm, WyRe, WyIm, WxRe, WxIm = self._cast(
            self.WzRe, self.WzIm, self.WyRe, self.WyIm, self.WxRe,
            self.WxIm)
        # z: real x complex
        are = jnp.einsum("bxyzc,zk->bxykc", v, WzRe,
                         preferred_element_type=f32, precision=prec)
        aim = jnp.einsum("bxyzc,zk->bxykc", v, WzIm,
                         preferred_element_type=f32, precision=prec)
        are, aim = self._cast(are, aim)
        # y: complex x complex
        bre = (jnp.einsum("bxykc,yj->bxjkc", are, WyRe,
                          preferred_element_type=f32, precision=prec)
               - jnp.einsum("bxykc,yj->bxjkc", aim, WyIm,
                            preferred_element_type=f32, precision=prec))
        bim = (jnp.einsum("bxykc,yj->bxjkc", are, WyIm,
                          preferred_element_type=f32, precision=prec)
               + jnp.einsum("bxykc,yj->bxjkc", aim, WyRe,
                            preferred_element_type=f32, precision=prec))
        bre, bim = self._cast(bre, bim)
        # x: complex x complex
        fre = (jnp.einsum("bxjkc,xi->bijkc", bre, WxRe,
                          preferred_element_type=f32, precision=prec)
               - jnp.einsum("bxjkc,xi->bijkc", bim, WxIm,
                            preferred_element_type=f32, precision=prec))
        fim = (jnp.einsum("bxjkc,xi->bijkc", bre, WxIm,
                          preferred_element_type=f32, precision=prec)
               + jnp.einsum("bxjkc,xi->bijkc", bim, WxRe,
                            preferred_element_type=f32, precision=prec))
        return fre, fim

    def scores(self, Hre: jax.Array, Him: jax.Array,
               vols: jax.Array) -> jax.Array:
        """Correlation score volumes ``[B, L, L, L]``.

        ``Hre/Him``: coupled receptor spectrum ``[L, L, L//2+1, C]``
        (from correlate.fft.receptor_transform, split re/im);
        ``vols``: ligand representations on the small box.
        S = irfftn( sum_c H_c conj(F_c) ).
        """
        f32 = jnp.float32
        prec = precision_for(self.dtype)
        fre, fim = self.ligand_spectrum(vols)
        Hre_, Him_ = self._cast(Hre, Him)
        fre, fim = self._cast(fre, fim)
        # H * conj(F), summed over channels.
        gre = (jnp.einsum("ijkc,bijkc->bijk", Hre_, fre,
                          preferred_element_type=f32, precision=prec)
               + jnp.einsum("ijkc,bijkc->bijk", Him_, fim,
                            preferred_element_type=f32, precision=prec))
        gim = (jnp.einsum("ijkc,bijkc->bijk", Him_, fre,
                          preferred_element_type=f32, precision=prec)
               - jnp.einsum("ijkc,bijkc->bijk", Hre_, fim,
                            preferred_element_type=f32, precision=prec))
        return self.inverse(gre, gim)

    def inverse(self, gre: jax.Array, gim: jax.Array) -> jax.Array:
        """irfftn of the summed spectrum ``G (re, im) [B, L, L, L/2+1]``
        as three axis contractions -> real ``[B, L, L, L]``."""
        f32 = jnp.float32
        prec = precision_for(self.dtype)
        gre, gim = self._cast(gre, gim)
        UxRe, UxIm, UyRe, UyIm, MzRe, MzIm = self._cast(
            self.UxRe, self.UxIm, self.UyRe, self.UyIm, self.MzRe,
            self.MzIm)
        # inverse x
        cre = (jnp.einsum("bijk,ix->bxjk", gre, UxRe,
                          preferred_element_type=f32, precision=prec)
               - jnp.einsum("bijk,ix->bxjk", gim, UxIm,
                            preferred_element_type=f32, precision=prec))
        cim = (jnp.einsum("bijk,ix->bxjk", gre, UxIm,
                          preferred_element_type=f32, precision=prec)
               + jnp.einsum("bijk,ix->bxjk", gim, UxRe,
                            preferred_element_type=f32, precision=prec))
        cre, cim = self._cast(cre, cim)
        # inverse y
        dre = (jnp.einsum("bxjk,jy->bxyk", cre, UyRe,
                          preferred_element_type=f32, precision=prec)
               - jnp.einsum("bxjk,jy->bxyk", cim, UyIm,
                            preferred_element_type=f32, precision=prec))
        dim = (jnp.einsum("bxjk,jy->bxyk", cre, UyIm,
                          preferred_element_type=f32, precision=prec)
               + jnp.einsum("bxjk,jy->bxyk", cim, UyRe,
                            preferred_element_type=f32, precision=prec))
        dre, dim = self._cast(dre, dim)
        # inverse z with Hermitian fold: S = Re{ sum_k d * Mz }
        S = (jnp.einsum("bxyk,kz->bxyz", dre, MzRe,
                        preferred_element_type=f32, precision=prec)
             - jnp.einsum("bxyk,kz->bxyz", dim, MzIm,
                          preferred_element_type=f32, precision=prec))
        return S


@functools.lru_cache(maxsize=8)
def get_correlator(grid_size: int, lig_grid: int,
                   dtype_name: str = "float32") -> DFTCorrelator:
    return DFTCorrelator(grid_size, lig_grid,
                         dtype=jnp.dtype(dtype_name))
