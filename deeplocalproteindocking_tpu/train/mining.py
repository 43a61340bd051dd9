"""FFT-mined hard negatives: the false-positive mining loop.

A model trained only on random decoys learns to beat random poses, not
the poses an exhaustive FFT sweep actually surfaces — its own top-
scoring false positives.  Mining closes the loop (the classic
refinement used across the FFT-docking lineage the reference belongs
to, cf. SURVEY.md §2.2 P7/P8): periodically run the CURRENT model's
global sweep over each training complex, keep the top-K poses with
their LRMSD labels, and feed them back as decoys
(data_gen.make_training_batch(mined=...)).

Runs the real sweep engine (sweep/resplat.py), so mining costs one
small global sweep per complex.
"""
from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.correlate.fft import (
    coupled_receptor, resolve_engine,
)
from deeplocalproteindocking_tpu.data.benchmark import (
    Complex, structure_to_device,
)
from deeplocalproteindocking_tpu.grids.voxelize import separable_splat
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations,
)
from deeplocalproteindocking_tpu.structure.transforms import apply_pose
from deeplocalproteindocking_tpu.train.decoys import DecoySet
from deeplocalproteindocking_tpu.train.scoring_path import train_lig_grid
from deeplocalproteindocking_tpu.utils.rmsd import rmsd


def merge_mined(old: Dict[str, DecoySet] | None,
                new: Dict[str, DecoySet], cap: int = 96
                ) -> Dict[str, DecoySet]:
    """Persistent negative buffer: accumulate mined poses across rounds.

    Replacing the buffer each mining round lets the model oscillate
    (whack-a-mole: suppressing the newest false positives re-opens the
    ones mined earlier — observed as val global top-1 cycling 0.375..0.75
    on the first flagship run).  Keeping every round's poses (most
    recent ``cap`` per complex) makes suppression cumulative, the
    standard persistent-contrastive trick for energy-based ranking.
    """
    if old is None:
        return dict(new)
    out = dict(old)
    for k, ds in new.items():
        o = out.get(k)
        if o is None:
            out[k] = ds
            continue
        out[k] = DecoySet(
            rotations=np.concatenate([o.rotations, ds.rotations])[-cap:],
            shifts=np.concatenate([o.shifts, ds.shifts])[-cap:],
            lrmsd=np.concatenate([o.lrmsd, ds.lrmsd])[-cap:])
    return out


def mine_hard_negatives(model, params, cfg: DockConfig,
                        complexes: Sequence[Complex],
                        *,
                        n_rotations: int = 256,
                        top_k: int = 32,
                        max_atoms: int | None = None,
                        ) -> Dict[str, DecoySet]:
    """Global-sweep each complex with the current model; return its
    top-K poses as LRMSD-labeled decoys, keyed by complex name."""
    from deeplocalproteindocking_tpu.sweep.resplat import (
        dock_sweep_resplat)
    if max_atoms is None:
        max_atoms = max(max(len(c.receptor.typed()),
                            len(c.ligand.typed())) for c in complexes)
    rotations = super_fibonacci_rotations(n_rotations)
    lig_grid = train_lig_grid(cfg)
    impl = resolve_engine(cfg.fft_impl, cfg.grid_size)

    def rep_fn(vols):
        return model.apply({"params": params}, vols,
                           method=model.represent)

    out: Dict[str, DecoySet] = {}
    for c in complexes:
        rc, rt, rm = structure_to_device(c.receptor.centered(), max_atoms)
        lc, lt, lm = structure_to_device(c.ligand.centered(), max_atoms)
        rec_vol = separable_splat(
            rc, rt, rm, grid_size=cfg.grid_size,
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types)
        rep_rec = model.apply({"params": params}, rec_vol,
                              method=model.represent)
        H = coupled_receptor(rep_rec, params["coupling"], impl)
        res = dock_sweep_resplat(
            H, lc, lt, lm, rotations, rep_fn,
            grid_size=cfg.grid_size, lig_grid=lig_grid,
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types, top_k=top_k,
            chunk=min(cfg.rotation_chunk, n_rotations),
            fft_impl=impl, dft_dtype=cfg.dft_dtype,
            fft_block=cfg.fft_block)
        Rs = rotations[res.rot_idx]
        shifts = res.shifts.astype(jnp.float32)
        nat = ((c.ligand.center - c.receptor.center)
               / cfg.resolution).astype(np.float32)
        native_pose = lc + jnp.asarray(nat) * cfg.resolution
        posed = apply_pose(lc[None], Rs, shifts * cfg.resolution)
        lrmsd = rmsd(posed, native_pose[None],
                     jnp.broadcast_to(lm[None], posed.shape[:-1]))
        out[c.name] = DecoySet(
            rotations=np.asarray(Rs),
            shifts=np.asarray(shifts),
            lrmsd=np.asarray(lrmsd))
    return out


def save_mined(path: str, mined: Dict[str, DecoySet]) -> None:
    """Serialize the persistent mined-negative buffer (atomic write).

    The buffer is training state: dropping it on resume re-opens the
    suppressed false positives until mining rounds rebuild it (round-2
    ADVICE).  One npz holds all complexes, keyed ``<name>/<field>``.
    """
    arrs = {}
    for name, ds in mined.items():
        arrs[f"{name}/rotations"] = np.asarray(ds.rotations)
        arrs[f"{name}/shifts"] = np.asarray(ds.shifts)
        arrs[f"{name}/lrmsd"] = np.asarray(ds.lrmsd)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrs)
    import os
    os.replace(tmp, path)


def load_mined(path: str) -> Dict[str, DecoySet]:
    """Inverse of :func:`save_mined`."""
    out: Dict[str, DecoySet] = {}
    with np.load(path) as z:
        names = sorted({k.rsplit("/", 1)[0] for k in z.files})
        for name in names:
            out[name] = DecoySet(
                rotations=z[f"{name}/rotations"],
                shifts=z[f"{name}/shifts"],
                lrmsd=z[f"{name}/lrmsd"])
    return out
