"""Overlap-save block-decomposed FFT correlation (SURVEY.md §5.7).

The long-context analog of this workload is spatial scale: a full-grid
correlation materializes ``[L, L, L/2+1, C]`` complex spectra — at
L=512, C=16 that is ~17 GB per rotation.  This module
computes the SAME score volume without ever forming an L-sized
transform, by the classic overlap-save decomposition (the convolution
counterpart of blockwise/ring attention):

* the translation grid is tiled into ``B^3`` blocks;
* for each block, a ``(B+Ls)^3`` receptor tile (wrap-padded, so the
  result matches the circular convention of ``correlate_scores``
  exactly) is correlated against the small ligand box with an
  ``M = B+Ls``-point FFT — every output in the block is alias-free
  because ``d + v < M`` for ``d < B``, ``v < Ls``;
* blocks are scanned on one device (peak memory = ONE tile's spectra)
  and/or sharded over a mesh axis (``sharded_block_correlate``) —
  each device owns a slab of translation blocks, receptor replicated,
  zero collectives in the correlation itself.

Per-block cost is ``O(M^3 log M)`` vs the monolithic ``O(L^3 log L)``;
total FLOPs grow by ``(1 + Ls/B)^3`` — the usual overlap-save tax —
in exchange for O(M^3) peak memory.  Extension engine for grids beyond
128^3; the 128^3 path stays the matmul-DFT (correlate/dft.py).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.numerics import precision_for

_AX = (0, 1, 2)


def _mixed_ligand(rep_lig_small: jax.Array,
                  coupling: Optional[jax.Array]) -> jax.Array:
    """Fold the channel coupling into the ligand (linear, real space):
    sum_c H_c conj(F[lig]_c) == sum_e F[rec]_e conj(F[lig~]_e) with
    lig~_e = sum_c A[e, c] lig_c."""
    if coupling is None:
        return rep_lig_small
    return jnp.einsum("xyzc,ec->xyze", rep_lig_small,
                      coupling.astype(rep_lig_small.dtype),
                      precision=precision_for(rep_lig_small.dtype))


@functools.partial(jax.jit, static_argnames=("block",))
def block_correlate_scores(rep_rec: jax.Array,
                           rep_lig_small: jax.Array,
                           coupling: Optional[jax.Array] = None,
                           *,
                           block: int = 32) -> jax.Array:
    """Score volume ``[L, L, L]`` == ``correlate_scores`` of the
    center-embedded small ligand box, computed blockwise.

    ``rep_rec [L, L, L, C]``; ``rep_lig_small [Ls, Ls, Ls, C]`` (the
    ligand's own box, embedded at offset ``(L - Ls)//2`` by
    convention); ``block`` must divide L.
    """
    L, Ls = rep_rec.shape[0], rep_lig_small.shape[0]
    C = rep_rec.shape[-1]
    if L % block:
        raise ValueError(f"block={block} must divide grid size {L}")
    B, M = block, block + Ls
    off = (L - Ls) // 2
    nb = L // B

    # Ligand at the ORIGIN of the M-box: corr[d] = sum_v tile[d+v] lig[v].
    lig = _mixed_ligand(rep_lig_small, coupling)
    ligM = jnp.zeros((M, M, M, C), rep_rec.dtype)
    ligM = ligM.at[:Ls, :Ls, :Ls].set(lig)
    F_lig_conj = jnp.conj(jnp.fft.rfftn(ligM, axes=_AX))

    # Wrap-pad so tile extraction matches circular-correlation
    # indexing.  The furthest tile ends at (L - B) + off + M, so the
    # pad must cover off + M extra — dynamic_slice silently CLAMPS
    # out-of-range starts, which corrupts the last blocks otherwise.
    pad = off + M
    rec_pad = jnp.pad(rep_rec, ((0, pad), (0, pad), (0, pad), (0, 0)),
                      mode="wrap")

    ids = jnp.arange(nb, dtype=jnp.int32) * B
    bx, by, bz = jnp.meshgrid(ids, ids, ids, indexing="ij")
    starts = jnp.stack([bx.ravel(), by.ravel(), bz.ravel()], axis=-1)

    def step(S, t0):
        tile = jax.lax.dynamic_slice(
            rec_pad, (t0[0] + off, t0[1] + off, t0[2] + off, 0),
            (M, M, M, C))
        G = jnp.sum(jnp.fft.rfftn(tile, axes=_AX) * F_lig_conj, axis=-1)
        corr = jnp.fft.irfftn(G, s=(M, M, M), axes=_AX)
        S = jax.lax.dynamic_update_slice(
            S, corr[:B, :B, :B], (t0[0], t0[1], t0[2]))
        return S, None

    S0 = jnp.zeros((L, L, L), jnp.float32)
    S, _ = jax.lax.scan(step, S0, starts)
    return S


def sharded_block_correlate(mesh, rep_rec: jax.Array,
                            rep_lig_small: jax.Array,
                            coupling: Optional[jax.Array] = None,
                            *,
                            block: int = 32,
                            axis: str = "rot") -> jax.Array:
    """Block correlation with translation slabs sharded over ``axis``.

    Each device computes the blocks whose first-axis start falls in its
    slab — receptor replicated, ligand replicated, NO collectives in
    the correlation (the downstream top-K merge is the only
    communication, as in the rotation-sharded sweep).  Returns the full
    ``[L, L, L]`` score volume (sharded along axis 0).
    """
    from jax.sharding import PartitionSpec as P
    L = rep_rec.shape[0]
    ndev = mesh.shape[axis]
    if (L // block) % ndev:
        raise ValueError(
            f"L/block={L // block} slabs must divide {ndev} devices")

    def shard_fn(rec, lig, cpl):
        # Inside shard_map each device sees the full (replicated)
        # receptor; compute only this device's slab of output blocks.
        idx = jax.lax.axis_index(axis)
        slab = L // ndev
        Ls = lig.shape[0]
        B, M = block, block + Ls
        off = (L - Ls) // 2
        C = rec.shape[-1]
        ligm = _mixed_ligand(lig, cpl)
        ligM = jnp.zeros((M, M, M, C), rec.dtype)
        ligM = ligM.at[:Ls, :Ls, :Ls].set(ligm)
        F_lig_conj = jnp.conj(jnp.fft.rfftn(ligM, axes=_AX))
        pad = off + M   # see block_correlate_scores: avoid slice clamp
        rec_pad = jnp.pad(rec, ((0, pad), (0, pad), (0, pad), (0, 0)),
                          mode="wrap")
        ids = jnp.arange(slab // B, dtype=jnp.int32) * B \
            + idx.astype(jnp.int32) * slab
        j = jnp.arange(L // B, dtype=jnp.int32) * B
        gx, gy, gz = jnp.meshgrid(ids, j, j, indexing="ij")
        starts = jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()],
                           axis=-1)

        def step(S, t0):
            tile = jax.lax.dynamic_slice(
                rec_pad, (t0[0] + off, t0[1] + off, t0[2] + off, 0),
                (M, M, M, C))
            G = jnp.sum(jnp.fft.rfftn(tile, axes=_AX) * F_lig_conj,
                        axis=-1)
            corr = jnp.fft.irfftn(G, s=(M, M, M), axes=_AX)
            base = idx.astype(jnp.int32) * slab
            S = jax.lax.dynamic_update_slice(
                S, corr[:B, :B, :B], (t0[0] - base, t0[1], t0[2]))
            return S, None

        S0 = jnp.zeros((slab, L, L), jnp.float32)
        S, _ = jax.lax.scan(step, S0, starts)
        return S

    cpl = (coupling if coupling is not None
           else jnp.eye(rep_rec.shape[-1], dtype=rep_rec.dtype))
    mapped = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=P(axis), check_vma=False)
    return mapped(rep_rec, rep_lig_small, cpl)
