"""Multi-device training step: complexes x decoys sharded over the mesh.

NEW relative to the single-GPU reference (SURVEY.md §2.3 "Training data
parallelism").  Two mesh axes are used:

* ``batch`` — complexes of the train batch (plain data parallelism);
* ``rot``   — each complex's decoy set (the workload's rotation-like
  axis): every device scores its slice of decoys, the score vectors are
  ``all_gather``-ed so the pairwise ranking hinge sees the full
  decoy set, and gradients flow back through the local slice only.

Gradients are averaged with ``psum`` over both axes (XLA inserts the
collectives from the shard_map specs; nothing NCCL-like is hand-written).
The model is ~10^5 params — replicated everywhere; there is no
tensor-parallel surface (SURVEY.md §2.3), which is a deliberate,
documented non-feature.
"""
from __future__ import annotations

import jax
import optax
from jax.sharding import Mesh, PartitionSpec as P

from deeplocalproteindocking_tpu.train.trainer import (
    TrainBatch, Trainer, TrainState,
)
from deeplocalproteindocking_tpu.train.losses import ranking_hinge_loss
from deeplocalproteindocking_tpu.train.scoring_path import complex_scores


def make_parallel_train_step(trainer: Trainer, mesh: Mesh):
    """Build a jitted multi-device train step over ``mesh`` (rot, batch).

    The returned function maps ``(TrainState, TrainBatch) ->
    (TrainState, metrics)`` with ``TrainBatch`` leaves sharded:
    complex dim over 'batch', decoy dim over 'rot'; params replicated.
    Requires batch size divisible by mesh 'batch' and decoy count
    divisible by mesh 'rot'.
    """
    cfg = trainer.config
    model = trainer.model
    optimizer = trainer.optimizer

    def local_complex_loss(params, rec_c, rec_t, rec_m, lig_c, lig_t,
                           lig_m, d_rot, d_shift, d_lrmsd_full):
        local_scores = complex_scores(model, cfg, params, rec_c, rec_t,
                                      rec_m, lig_c, lig_t, lig_m,
                                      d_rot, d_shift)
        # Full decoy score vector: the ranking loss pairs every
        # near-native with every decoy, so scores cross shards.
        scores = jax.lax.all_gather(local_scores, "rot").reshape(-1)
        return ranking_hinge_loss(
            scores, d_lrmsd_full, near_native_rmsd=cfg.near_native_rmsd,
            margin=cfg.hinge_margin)

    def shard_loss(params, batch: TrainBatch):
        losses = jax.vmap(
            lambda rc, rt, rm, lc, lt, lm, dr, ds, dl:
            local_complex_loss(params, rc, rt, rm, lc, lt, lm, dr, ds, dl)
        )(batch.rec_coords, batch.rec_types, batch.rec_mask,
          batch.lig_coords, batch.lig_types, batch.lig_mask,
          batch.decoy_rot, batch.decoy_shift, batch.decoy_lrmsd)
        # Local mean only — cross-shard averaging happens on the grads
        # (pmean), the standard DP pattern.
        return losses.mean()

    batch_specs = TrainBatch(
        rec_coords=P("batch"), rec_types=P("batch"), rec_mask=P("batch"),
        lig_coords=P("batch"), lig_types=P("batch"), lig_mask=P("batch"),
        decoy_rot=P("batch", "rot"), decoy_shift=P("batch", "rot"),
        decoy_lrmsd=P("batch"),  # labels replicated over rot (full set)
    )

    def step_fn(state: TrainState, batch: TrainBatch):
        def sharded_grad(params, b):
            loss, grads = jax.value_and_grad(shard_loss)(params, b)
            # pmean over BOTH axes: over 'batch' it averages disjoint
            # complex shards (plain DP); over 'rot' the psum collects the
            # disjoint per-decoy gradient paths while the /n_rot cancels
            # the n_rot-fold replication introduced by the all_gather
            # transpose (every rot shard differentiates the same full
            # pairwise loss).
            grads = jax.lax.pmean(grads, ("rot", "batch"))
            loss = jax.lax.pmean(loss, ("rot", "batch"))
            return loss, grads

        mapped = jax.shard_map(
            sharded_grad, mesh=mesh,
            in_specs=(P(), batch_specs),
            out_specs=(P(), P()),
            check_vma=False)
        loss, grads = mapped(state.params, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1, key=state.key),
                {"loss": loss})

    return jax.jit(step_fn)
