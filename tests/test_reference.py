"""The dft sweep against the plain jnp.fft reference (sweep/reference.py).

The same check runs on the card at 128^3 with the flagship model
(``chip_smoke.py`` phase 3); here it runs at a CPU-sized grid."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.correlate.fft import translation_mask
from deeplocalproteindocking_tpu.data import synthetic_complex
from deeplocalproteindocking_tpu.data.benchmark import structure_to_device
from deeplocalproteindocking_tpu.pipeline import DockingPipeline
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_tpu.sweep.docker import DockResult
from deeplocalproteindocking_tpu.sweep.reference import (
    reference_sweep, topk_agreement)
from deeplocalproteindocking_tpu.sweep.resplat import dock_sweep_resplat

L, LS, K, NROT = 24, 16, 8, 6


@pytest.fixture(scope="module")
def case():
    cfg = DockConfig(grid_size=L, resolution=1.5, rep_features=(4, 3),
                     shape_prior=True, top_k=K)
    pipe = DockingPipeline(config=cfg)
    pipe.init_params(seed=0)
    cplx = synthetic_complex(seed=3, n_res_rec=8, n_res_lig=4)
    rec_c, lig_c, rep_rec, _, coupling = pipe._prepare(cplx.receptor,
                                                       cplx.ligand)
    impl, H, rep_fn = pipe._engine_parts(rep_rec, coupling)
    assert impl == "dft"
    lc, lt, lm = structure_to_device(lig_c)
    kw = dict(grid_size=L, lig_grid=LS, resolution=cfg.resolution,
              sigma=cfg.sigma, num_types=cfg.num_atom_types, top_k=K)
    return H, (lc, lt, lm), super_fibonacci_rotations(NROT), rep_fn, kw


@pytest.mark.parametrize("masked", [False, True])
def test_dft_sweep_matches_fft_reference(case, masked):
    H, lig, rots, rep_fn, kw = case
    mask = translation_mask(L, 5) if masked else None
    ref, smax, score_at = reference_sweep(H, *lig, rots, rep_fn,
                                          score_mask=mask, **kw)
    got = dock_sweep_resplat(H, *lig, rots, rep_fn, chunk=4,
                             score_mask=mask, fft_impl="dft", **kw)
    agree = topk_agreement(ref, got, 1e-4 * smax, score_at)
    assert agree["ok"], agree
    assert agree["top1_same"]
    if masked:
        assert (np.abs(np.asarray(got.shifts)) <= 5).all()


def test_agreement_flags_a_wrong_pose(case):
    H, lig, rots, rep_fn, kw = case
    ref, smax, score_at = reference_sweep(H, *lig, rots, rep_fn, **kw)
    # Replace the best pose by one the reference scores far lower.
    bad_rot = (int(ref.rot_idx[0]) + 1) % NROT
    shifts = np.asarray(ref.shifts).copy()
    shifts[0] = [L // 2 - 1] * 3
    wrong = DockResult(scores=ref.scores,
                       rot_idx=jnp.asarray(ref.rot_idx).at[0].set(bad_rot),
                       shifts=jnp.asarray(shifts))
    agree = topk_agreement(ref, wrong, 1e-4 * smax, score_at)
    assert not agree["ok"] and agree["swaps"] == 1
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, wrong)
