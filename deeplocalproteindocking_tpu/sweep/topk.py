"""Exact two-stage top-K for huge score volumes.

``jax.lax.top_k`` over a 128^3 = 2.1M-element score volume is a sort
over every cell of every rotation.  This module computes the EXACT
top-K two-stage:

1. block-reduce: max over contiguous blocks of ``block`` elements
   (a streaming reduction over the minor axis);
2. ``top_k`` over the ~n/block block-maxes (block times cheaper);
3. gather the K winning blocks' full contents (K x block candidates)
   and re-``top_k``.

Exactness: any element e outside the K max-blocks satisfies
``e <= max(its block) < each of the K selected block maxes``, so at
least K elements beat it and e cannot be in the top-K.  (Ties are a
value-set tie: the returned VALUES are exactly the top-K multiset;
which of several equal-valued cells is returned may differ from
``lax.top_k``'s index order, same as any tie-breaking scheme.)

This replaces the reference's per-rotation peak harvest
[U: DeepLocalProteinDocking/Models/EQDockerGPU.py — mount empty] with
an exact reduction that sorts only block maxima.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def exact_block_topk(x: jax.Array, k: int, block: int = 32,
                     block2: int | None = 32):
    """Exact top-k over the last axis of ``x [B, n]``.

    Returns ``(values [B, k], flat_indices [B, k])`` — the same value
    multiset as ``jax.lax.top_k(x, k)`` (index tie-order may differ).
    ``n`` must be divisible by ``block``; ``n // block >= k``.

    ``block2`` adds a SECOND max-reduction level (round-3): at 128^3
    the single-level scheme still ran ``top_k`` over n/block = 65k
    block maxes — the dominant sort.  With a second level the sort
    runs over n/(block*block2) = 2k super-maxes; the two drill-down
    stages each re-``top_k`` only k*block2 / k*block candidates.

    Two-level exactness: an element e outside the k selected
    super-blocks is beaten by each selected super-max (>= k elements).
    An element e inside a selected super-block has its own level-1
    block in the level-1 candidate set; if that block is not among the
    k selected there, k candidate blocks' maxes beat e.  Either way at
    least k elements beat e, so e cannot be in the top-k.
    """
    B, n = x.shape
    if n % block:
        raise ValueError(f"n={n} not divisible by block={block}")
    nb = n // block
    if nb < k:
        # Degenerate: fewer blocks than k — plain top_k is cheap here.
        return jax.lax.top_k(x, k)
    xb = x.reshape(B, nb, block)
    bmax = xb.max(axis=-1)                              # [B, nb]
    if (block2 and nb % block2 == 0 and nb // block2 >= k
            and nb >= 16 * block2):
        nb2 = nb // block2
        bmax2 = bmax.reshape(B, nb2, block2).max(axis=-1)
        _, sidx = jax.lax.top_k(bmax2, k)               # super-blocks
        cand1 = jnp.take_along_axis(
            bmax.reshape(B, nb2, block2), sidx[:, :, None], axis=1)
        _, c1 = jax.lax.top_k(cand1.reshape(B, k * block2), k)
        bidx = jnp.take_along_axis(sidx, c1 // block2,
                                   axis=1) * block2 + c1 % block2
    else:
        _, bidx = jax.lax.top_k(bmax, k)                # [B, k]
    # Gather the k winning blocks' contents: [B, k, block].
    cand = jnp.take_along_axis(xb, bidx[:, :, None], axis=1)
    vals, ci = jax.lax.top_k(cand.reshape(B, k * block), k)
    # ci = j * block + o where j indexes the selected blocks.
    flat = jnp.take_along_axis(bidx, ci // block, axis=1) * block \
        + ci % block
    return vals, flat
