"""Training-batch assembly: complexes -> padded TrainBatch with decoys.

Bridges the host-side dataset (data/benchmark.py) and the jitted train
step: picks complexes, centers receptor/ligand, snaps the native shift
to the voxel lattice, samples labeled decoy sets (train/decoys.py), and
pads atom counts so the batch has static shapes.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.data.benchmark import (
    Complex, structure_to_device,
)
from deeplocalproteindocking_tpu.numerics import precision_for
from deeplocalproteindocking_tpu.train.decoys import generate_decoys
from deeplocalproteindocking_tpu.train.trainer import TrainBatch


def native_voxel_shift(cplx: Complex, resolution: float) -> np.ndarray:
    """Native ligand placement as an integer voxel shift (see decoys.py)."""
    t = (cplx.ligand.center - cplx.receptor.center) / resolution
    return np.round(t).astype(np.int32)


def fit_lig_grid(complexes: Sequence[Complex],
                 cfg: DockConfig) -> DockConfig:
    """Auto-size the static training ligand box to the dataset.

    Training shapes are static under jit, so the box is fixed per run:
    size it once from the LARGEST ligand (atoms + 3-sigma splat tails +
    CNN receptive field, like sweep/resplat.py:auto_ligand_grid) instead
    of hard-failing on big ligands.  No-op when ``cfg.lig_grid_size`` is
    already set explicitly.
    """
    if cfg.lig_grid_size is not None or cfg.sweep_mode != "resplat":
        return cfg
    from deeplocalproteindocking_tpu.sweep.resplat import auto_ligand_grid
    rf = len(cfg.rep_features) * (cfg.rep_kernel // 2) + 1
    ls = max(auto_ligand_grid(c.ligand.centered().coords,
                              cfg.resolution, cfg.sigma, rf,
                              cfg.grid_size)
             for c in complexes)
    ls = max(ls, cfg.grid_size // 2)  # never below the old default
    return cfg.replace(lig_grid_size=ls)


def make_training_batch(key: jax.Array,
                        complexes: Sequence[Complex],
                        cfg: DockConfig,
                        max_atoms: int | None = None,
                        mined: dict | None = None) -> TrainBatch:
    """Sample ``cfg.batch_complexes`` complexes and their decoy sets.

    Decoy composition per complex (``cfg.num_decoys`` total):

    * local perturbations around the native pose (cone + small shifts,
      native included) — the reference's local-docking curriculum;
    * ``cfg.decoy_global_frac`` drawn GLOBALLY (full SO(3) x box-wide
      shifts) so arbitrary poses are in-distribution for global sweeps;
    * when ``mined`` (a ``{complex.name: DecoySet}`` buffer from
      train/mining.py) is given, up to ``cfg.mined_frac`` replaced by
      FFT-mined hard negatives — the top-scoring WRONG poses of the
      current model, the classic false-positive mining loop.

    ``decoy_shift`` is emitted float32: mined poses pass through the
    joint SO(3) augmentation, which rotates shifts off the integer
    lattice (scores are evaluated by Fourier phase, no gather needed).
    """
    if max_atoms is None:
        max_atoms = max(max(len(c.receptor.typed()), len(c.ligand.typed()))
                        for c in complexes)
    if cfg.sweep_mode == "resplat":
        from deeplocalproteindocking_tpu.train.scoring_path import (
            train_lig_grid)
        half_box = 0.5 * train_lig_grid(cfg) * cfg.resolution
        for c in complexes:
            lig = c.ligand.centered()
            # Rotation-invariant bound: decoys + R0 augmentation rotate
            # the ligand inside the box, so the L2 radius (not the
            # per-axis max of one orientation) decides containment.
            extent = float(np.linalg.norm(lig.coords, axis=1).max()
                           ) + 3.0 * cfg.sigma
            if extent > half_box:
                raise ValueError(
                    f"ligand of {c.name} (extent {extent:.1f} A) exceeds "
                    f"the training ligand box ({half_box:.1f} A half-"
                    f"width); raise config.lig_grid_size or let "
                    f"data_gen.fit_lig_grid auto-size it from the "
                    f"dataset (the CLI does this)")
    k_pick, key = jax.random.split(key)
    idx = jax.random.randint(k_pick, (cfg.batch_complexes,), 0,
                             len(complexes))
    rows = {f: [] for f in TrainBatch._fields}
    for j, i in enumerate(np.asarray(idx)):
        cplx = complexes[int(i)]
        rc, rt, rm = structure_to_device(cplx.receptor.centered(),
                                         max_atoms)
        lc, lt, lm = structure_to_device(cplx.ligand.centered(), max_atoms)
        nat_f = (cplx.ligand.center - cplx.receptor.center) / cfg.resolution
        if cfg.augment_rotations:
            # Joint rotation of the whole complex: the reference's EQ
            # models get rotational robustness from augmentation, not
            # architecture.  Rotating (rec, lig, native shift) together
            # preserves all LRMSD labels exactly.
            key, k_r = jax.random.split(key)
            from deeplocalproteindocking_tpu.structure.transforms import (
                random_rotations, rotate)
            R0 = random_rotations(k_r, 1)[0]
            rc = rotate(rc, R0) * rm[:, None]
            lc = rotate(lc, R0) * lm[:, None]
            nat_f = np.asarray(R0) @ np.asarray(nat_f)
        nat = jnp.asarray(np.round(np.asarray(nat_f)).astype(np.int32))

        buf = (mined or {}).get(cplx.name)
        n_mined = (min(int(round(cfg.mined_frac * cfg.num_decoys)),
                       len(buf.lrmsd)) if buf is not None else 0)
        n_global = int(round(cfg.decoy_global_frac * cfg.num_decoys))
        n_local = max(1, cfg.num_decoys - n_global - n_mined)
        n_global = cfg.num_decoys - n_local - n_mined

        key, k_d = jax.random.split(key)
        dec = generate_decoys(
            k_d, lc, lm, nat, n=n_local,
            resolution=cfg.resolution,
            max_angle=float(np.deg2rad(cfg.decoy_max_angle_deg)),
            max_shift=cfg.decoy_max_shift)
        rot_parts = [dec.rotations]
        shift_parts = [dec.shifts.astype(jnp.float32)]
        lrmsd_parts = [dec.lrmsd]
        if n_global > 0:
            from deeplocalproteindocking_tpu.train.decoys import (
                generate_global_decoys)
            lig_half_vox = int(np.ceil(
                (float(np.abs(np.asarray(lc)).max()) + 3.0 * cfg.sigma)
                / cfg.resolution))
            cap = max(1, cfg.grid_size // 2 - lig_half_vox - 1)
            key, k_g = jax.random.split(key)
            g = generate_global_decoys(k_g, lc, lm, nat, n=n_global,
                                       resolution=cfg.resolution,
                                       max_shift_vox=cap)
            rot_parts.append(g.rotations)
            shift_parts.append(g.shifts.astype(jnp.float32))
            lrmsd_parts.append(g.lrmsd)
        if n_mined > 0:
            key, k_m = jax.random.split(key)
            pick = np.asarray(jax.random.choice(
                k_m, len(buf.lrmsd), (n_mined,), replace=False))
            mR = jnp.asarray(np.asarray(buf.rotations)[pick], jnp.float32)
            mS = jnp.asarray(np.asarray(buf.shifts)[pick], jnp.float32)
            mL = jnp.asarray(np.asarray(buf.lrmsd)[pick], jnp.float32)
            if cfg.augment_rotations:
                # Mined poses live in the canonical frame; transport
                # them to the R0-rotated frame: x' = R0 x, so
                # R' = R0 R R0^T and s' = R0 s (labels are invariant).
                hi = precision_for()
                mR = jnp.einsum("ij,djk,lk->dil", R0, mR, R0,
                                precision=hi)
                mS = jnp.einsum("ij,dj->di", R0, mS, precision=hi)
            rot_parts.append(mR)
            shift_parts.append(mS)
            lrmsd_parts.append(mL)
        for f, v in zip(TrainBatch._fields,
                        (rc, rt, rm, lc, lt, lm,
                         jnp.concatenate(rot_parts),
                         jnp.concatenate(shift_parts),
                         jnp.concatenate(lrmsd_parts))):
            rows[f].append(v)
    return TrainBatch(**{f: jnp.stack(v) for f, v in rows.items()})
