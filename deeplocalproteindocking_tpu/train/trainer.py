"""End-to-end representation training: optimizer loop + checkpointing.

Capability parity with the reference's trainer
[U: DeepLocalProteinDocking/Training, train.py — mount empty,
unverified]: per-complex decoy batches, pairwise ranking hinge, Adam,
periodic checkpoints.  Gradients flow model-params -> representation ->
FFT correlator score gather, and the voxelizer itself is on the autodiff
path (coords -> volume -> rep), matching BASELINE.json: north_star.

Design:

* one jitted ``train_step`` over a *batch* of complexes (vmap), with the
  per-decoy rotate+correlate wrapped in ``jax.checkpoint`` inside a
  sequential ``lax.map`` — reverse-mode memory stays O(one decoy), the
  classic remat trade (SURVEY.md §7 hard part 4);
* one ``step_<N>.npz`` per checkpoint holding (params, opt_state, step,
  rng) by key path, replacing the reference's ``torch.save``
  (SURVEY.md §5.4);
* a data-parallel variant lives in ``parallel/train_parallel.py``.
"""
from __future__ import annotations

import os
import re
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.models.scoring import ScoringModel
from deeplocalproteindocking_tpu.train.losses import (
    pairwise_ranking_accuracy, ranking_hinge_loss,
)


class TrainBatch(NamedTuple):
    """Padded batch of complexes with pre-generated decoy sets."""
    rec_coords: jax.Array   # [B, N, 3]
    rec_types: jax.Array    # [B, N]
    rec_mask: jax.Array     # [B, N]
    lig_coords: jax.Array   # [B, M, 3]  (centered)
    lig_types: jax.Array    # [B, M]
    lig_mask: jax.Array     # [B, M]
    decoy_rot: jax.Array    # [B, D, 3, 3]
    decoy_shift: jax.Array  # [B, D, 3] int32 voxel shifts
    decoy_lrmsd: jax.Array  # [B, D]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array
    key: jax.Array


class Trainer:
    def __init__(self, config: DockConfig):
        self.config = config
        self.model = ScoringModel(features=config.rep_features,
                                  kernel=config.rep_kernel,
                                  shape_prior=config.shape_prior)
        lr = (optax.cosine_decay_schedule(
                  config.learning_rate, config.lr_decay_steps, alpha=0.1)
              if config.lr_decay_steps > 0 else config.learning_rate)
        self.optimizer = (
            optax.adamw(lr, weight_decay=config.weight_decay)
            if config.weight_decay > 0.0
            else optax.adam(lr))
        self._step_fn = jax.jit(self._train_step)

    # ---- setup ----
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        cfg = self.config
        key = jax.random.key(cfg.seed if seed is None else seed)
        k_init, key = jax.random.split(key)
        # Tiny dummy: conv param shapes don't depend on spatial dims.
        dummy = jnp.zeros((16,) * 3 + (cfg.num_atom_types,))
        params = self.model.init(k_init, dummy, dummy)["params"]
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params),
                          step=jnp.zeros((), jnp.int32), key=key)

    # ---- forward/loss ----
    def _complex_loss(self, params, rec_c, rec_t, rec_m,
                      lig_c, lig_t, lig_m, d_rot, d_shift, d_lrmsd):
        from deeplocalproteindocking_tpu.train.scoring_path import (
            complex_scores)
        cfg = self.config
        scores = complex_scores(self.model, cfg, params, rec_c, rec_t,
                                rec_m, lig_c, lig_t, lig_m, d_rot,
                                d_shift)
        loss = ranking_hinge_loss(
            scores, d_lrmsd, near_native_rmsd=cfg.near_native_rmsd,
            margin=cfg.hinge_margin)
        acc = pairwise_ranking_accuracy(scores, d_lrmsd,
                                        cfg.near_native_rmsd)
        return loss, acc

    def loss_fn(self, params, batch: TrainBatch):
        losses, accs = jax.vmap(
            lambda *a: self._complex_loss(params, *a))(*batch)
        return losses.mean(), accs.mean()

    def _train_step(self, state: TrainState, batch: TrainBatch):
        (loss, acc), grads = jax.value_and_grad(
            self.loss_fn, has_aux=True)(state.params, batch)
        updates, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1, key=state.key)
        return new_state, {"loss": loss, "ranking_accuracy": acc}

    def train_step(self, state: TrainState, batch: TrainBatch):
        return self._step_fn(state, batch)

    # ---- checkpointing (SURVEY.md §5.4) ----
    def save(self, ckpt_dir: str, state: TrainState) -> str:
        """Write ``step_<N>.npz`` (+ ``config.json``); returns its path."""
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"step_{int(state.step):08d}.npz")
        arrays = flatten_state(dict(params=state.params,
                                    opt_state=state.opt_state))
        arrays["step"] = np.asarray(state.step)
        arrays["key"] = np.asarray(jax.random.key_data(state.key))
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            f.write(self.config.to_json())
        return path

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> TrainState:
        if step is None:
            steps = checkpoint_steps(ckpt_dir)
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
            step = steps[-1]
        path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
        template = self.init_state()
        with np.load(path) as z:
            tree = unflatten_state(
                dict(params=template.params,
                     opt_state=template.opt_state), z, path)
            return TrainState(
                params=tree["params"], opt_state=tree["opt_state"],
                step=jnp.asarray(z["step"], jnp.int32),
                key=jax.random.wrap_key_data(jnp.asarray(z["key"])))


_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")


def checkpoint_steps(ckpt_dir: str) -> list:
    """Sorted step numbers of the ``step_<N>.npz`` files in a dir."""
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(ckpt_dir)) if m)


def _key_name(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def flatten_state(tree) -> dict:
    """``{"params/representation/cnn/conv0/kernel": ndarray, ...}``."""
    return {_key_name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def unflatten_state(template, arrays, where: str = "checkpoint"):
    """Fill ``template``'s leaves from ``arrays`` by key path; a missing
    name or a shape that differs from the template is an error."""
    def leaf(p, t):
        name = _key_name(p)
        if name not in arrays:
            raise KeyError(f"{where}: no array {name!r}")
        v = np.asarray(arrays[name])
        if v.shape != np.shape(t):
            raise ValueError(f"{where}: {name!r} has shape {v.shape}, "
                             f"the model wants {np.shape(t)}")
        return jnp.asarray(v, dtype=jnp.asarray(t).dtype)
    return jax.tree_util.tree_map_with_path(leaf, template)
