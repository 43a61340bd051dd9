"""Batched multi-complex docking over the full (rot, batch) mesh.

BASELINE.json configs[4]: batched multi-complex Benchmark-5 evaluation
with rotation sharding across several devices.  The reference's
analog is an outer Python loop over complexes (single GPU); here a group
of complexes is padded to common shapes and docked as ONE compiled
program over a 2-D mesh:

* mesh axis ``batch`` shards the complex dimension (pure data
  parallelism — no cross-complex communication at all);
* mesh axis ``rot`` shards each complex's rotation set exactly as in
  sharded_sweep.py (all-gather of K candidates is the only
  collective).

Each device therefore owns a (complex-slice x rotation-slice) tile of
the benchmark workload.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deeplocalproteindocking_tpu.sweep.docker import DockResult
from deeplocalproteindocking_tpu.sweep.resplat import dock_sweep_resplat


def dock_batch(mesh: Optional[Mesh],
               H_batch: jax.Array,
               lig_coords: jax.Array,
               lig_types: jax.Array,
               lig_mask: jax.Array,
               rotations: jax.Array,
               rep_fn: Callable,
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
               fft_block: int = 32) -> DockResult:
    """Dock ``B`` complexes against one rotation set in one program.

    ``H_batch [B, L, L, L//2+1, C]`` coupled receptor spectra;
    ``lig_* [B, ...]`` padded ligand arrays; ``score_mask [B, L, L, L]``
    optional per-complex translation masks (circular-wraparound guard /
    local-docking restriction — same semantics as pipeline.dock).
    Returns ``DockResult`` with leading batch dim ``[B, K]``.  With
    ``mesh=None`` runs unsharded (vmap only); with a mesh, B must
    divide by mesh['batch'].
    """
    kw = dict(grid_size=grid_size, lig_grid=lig_grid,
              resolution=resolution, sigma=sigma, num_types=num_types,
              top_k=top_k, chunk=chunk, fft_impl=fft_impl,
              dft_dtype=dft_dtype, fft_block=fft_block)

    if mesh is None:
        if score_mask is None:
            return jax.vmap(
                lambda h, lc, lt, lm: dock_sweep_resplat(
                    h, lc, lt, lm, rotations, rep_fn, **kw)
            )(H_batch, lig_coords, lig_types, lig_mask)
        return jax.vmap(
            lambda h, lc, lt, lm, sm: dock_sweep_resplat(
                h, lc, lt, lm, rotations, rep_fn, score_mask=sm, **kw)
        )(H_batch, lig_coords, lig_types, lig_mask, score_mask)

    n_rot_dev = mesh.shape["rot"]
    n_rot = rotations.shape[0]
    per_shard = -(-n_rot // (n_rot_dev * chunk)) * chunk
    pad = per_shard * n_rot_dev - n_rot
    if pad:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=rotations.dtype),
                               (pad, 3, 3))
        rotations_p = jnp.concatenate([rotations, eye], axis=0)
    else:
        rotations_p = rotations

    if score_mask is None:
        # Trivial all-pass masks keep one shard_map signature; the cost
        # is one broadcast AND that XLA folds away.
        score_mask = jnp.ones(
            (H_batch.shape[0],) + (grid_size,) * 3, dtype=bool)

    def shard_fn(hb, lc, lt, lm, sm, rots, n_valid):
        shard = jax.lax.axis_index("rot")
        base = (shard * per_shard).astype(jnp.int32)
        local_valid = jnp.clip(n_valid - base, 0, per_shard)

        def one(h, c, t, m, mask1):
            res = dock_sweep_resplat(h, c, t, m, rots, rep_fn,
                                     num_valid=local_valid,
                                     score_mask=mask1, **kw)
            rot_idx = res.rot_idx + base
            valid = rot_idx < n_valid
            scores = jnp.where(valid, res.scores, -jnp.inf)
            all_scores = jax.lax.all_gather(scores, "rot").reshape(-1)
            all_rot = jax.lax.all_gather(rot_idx, "rot").reshape(-1)
            all_shift = jax.lax.all_gather(res.shifts,
                                           "rot").reshape(-1, 3)
            best, sel = jax.lax.top_k(all_scores, top_k)
            return DockResult(scores=best, rot_idx=all_rot[sel],
                              shifts=all_shift[sel])

        return jax.vmap(one)(hb, lc, lt, lm, sm)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("batch"), P("batch"), P("batch"), P("batch"),
                  P("batch"), P("rot"), P()),
        out_specs=DockResult(scores=P("batch"), rot_idx=P("batch"),
                             shifts=P("batch")),
        check_vma=False)
    n_valid = jnp.asarray(n_rot, dtype=jnp.int32)
    return mapped(H_batch, lig_coords, lig_types, lig_mask, score_mask,
                  rotations_p, n_valid)
