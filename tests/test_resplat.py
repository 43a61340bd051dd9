"""Resplat sweep mode: gather-free rotation via coordinate re-splat."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deeplocalproteindocking_tpu.correlate import receptor_transform
from deeplocalproteindocking_tpu.grids.voxelize import (
    separable_splat, splat,
)
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations,
)
from deeplocalproteindocking_tpu.structure.transforms import (
    axis_angle_to_matrix, rotate,
)
from deeplocalproteindocking_tpu.sweep import dock_sweep
from deeplocalproteindocking_tpu.sweep.resplat import (
    auto_ligand_grid, dock_sweep_resplat, embed_small,
    score_decoys_resplat,
)


def _atoms(n=12, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    coords = jnp.asarray(
        rng.uniform(-spread, spread, (n, 3)).astype(np.float32))
    types = jnp.asarray(rng.integers(0, 4, n).astype(np.int32))
    mask = jnp.ones(n)
    return coords, types, mask


def _identity_rep(vols):
    return vols


class TestSeparableSplat:
    def test_matches_scatter_splat(self):
        coords, types, mask = _atoms(n=30)
        a = separable_splat(coords, types, mask, grid_size=20,
                            resolution=1.0, num_types=4)
        b = splat(coords, types, mask, grid_size=20, resolution=1.0,
                  num_types=4, window=12)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5)

    def test_differentiable(self):
        coords, types, mask = _atoms(n=5)
        probe = jax.random.normal(jax.random.key(0), (16, 16, 16, 4))

        def loss(c):
            return jnp.vdot(probe, separable_splat(
                c, types, mask, grid_size=16, resolution=1.0,
                num_types=4))
        g = jax.grad(loss)(coords)
        eps = 1e-3
        e = jnp.zeros_like(coords).at[1, 2].set(eps)
        fd = (loss(coords + e) - loss(coords - e)) / (2 * eps)
        np.testing.assert_allclose(float((g * e).sum() / eps), float(fd),
                                   rtol=2e-2, atol=1e-4)


class TestEmbed:
    def test_embed_centered(self):
        small = jnp.ones((4, 4, 4, 2))
        big = embed_small(small, 8)
        assert big.shape == (8, 8, 8, 2)
        assert float(big.sum()) == float(small.sum())
        assert float(big[2:6, 2:6, 2:6].sum()) == float(small.sum())

    def test_embed_matches_direct_splat(self):
        # splat on small box then embed == splat on big box directly,
        # when the structure fits in the small box.
        coords, types, mask = _atoms(n=10, spread=3.0)
        small = separable_splat(coords, types, mask, grid_size=16,
                                resolution=1.0, num_types=4)
        direct = separable_splat(coords, types, mask, grid_size=32,
                                 resolution=1.0, num_types=4)
        np.testing.assert_allclose(np.asarray(embed_small(small, 32)),
                                   np.asarray(direct), atol=1e-4)


class TestResplatSweep:
    def test_matches_resample_sweep_identity_rep(self):
        # With rep = density itself and the same rotations, resplat and
        # the rotate-volume sweep are the same model up to interpolation
        # error; at identity rotation they agree exactly.
        L = 24
        coords, types, mask = _atoms(n=12, spread=4.0)
        rec = separable_splat(coords + 2.0, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        lig_vol = separable_splat(coords, types, mask, grid_size=L,
                                  resolution=1.0, num_types=4)
        H = receptor_transform(rec)
        res_a = dock_sweep(rec, lig_vol, jnp.eye(3)[None], top_k=4,
                           chunk=1)
        res_b = dock_sweep_resplat(
            H, coords, types, mask, jnp.eye(3)[None], _identity_rep,
            grid_size=L, lig_grid=L, resolution=1.0, sigma=1.0,
            num_types=4, top_k=4, chunk=1)
        np.testing.assert_allclose(np.asarray(res_a.scores),
                                   np.asarray(res_b.scores), rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(res_a.shifts),
                                      np.asarray(res_b.shifts))

    def test_planted_rotation_translation(self):
        # Small ligand box (lig_grid < L): plant a 90-degree pose.
        L = 24
        coords, types, mask = _atoms(n=10, spread=3.0)
        R_true = axis_angle_to_matrix(jnp.array([0.0, 0.0, 1.0]),
                                      jnp.array(np.pi / 2))
        shift = np.array([2.0, -1.0, 3.0], dtype=np.float32)
        rec = separable_splat(rotate(coords, R_true) + shift, types, mask,
                              grid_size=L, resolution=1.0, num_types=4)
        H = receptor_transform(rec)
        angles = [0.0, np.pi / 2, np.pi, 3 * np.pi / 2]
        rots = jnp.stack([axis_angle_to_matrix(jnp.array([0.0, 0.0, 1.0]),
                                               jnp.array(a))
                          for a in angles])
        res = dock_sweep_resplat(
            H, coords, types, mask, rots, _identity_rep, grid_size=L,
            lig_grid=16, resolution=1.0, sigma=1.0, num_types=4,
            top_k=4, chunk=2)
        assert int(res.rot_idx[0]) == 1
        np.testing.assert_array_equal(np.asarray(res.shifts[0]),
                                      shift.astype(int))

    def test_score_decoys_matches_sweep(self):
        L = 16
        coords, types, mask = _atoms(n=8, spread=2.5)
        rec = separable_splat(coords + 1.0, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        H = receptor_transform(rec)
        rots = super_fibonacci_rotations(3)
        res = dock_sweep_resplat(
            H, coords, types, mask, rots, _identity_rep, grid_size=L,
            lig_grid=12, resolution=1.0, sigma=1.0, num_types=4,
            top_k=2, chunk=1)
        # Re-score the top poses through the training path.
        scores = score_decoys_resplat(
            H, coords, types, mask,
            jnp.asarray(np.asarray(rots)[np.asarray(res.rot_idx)]),
            res.shifts, _identity_rep, grid_size=L, lig_grid=12,
            resolution=1.0, sigma=1.0, num_types=4)
        np.testing.assert_allclose(np.asarray(scores),
                                   np.asarray(res.scores), rtol=1e-4)

    def test_sharded_matches_single(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from deeplocalproteindocking_tpu.parallel.mesh import make_mesh
        from deeplocalproteindocking_tpu.parallel.sharded_sweep import (
            sharded_dock_sweep_resplat)
        L = 16
        coords, types, mask = _atoms(n=8, spread=2.5)
        rec = separable_splat(coords + 1.0, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        H = receptor_transform(rec)
        rots = super_fibonacci_rotations(13)   # uneven over 8 shards
        kw = dict(grid_size=L, lig_grid=12, resolution=1.0, sigma=1.0,
                  num_types=4, top_k=8, chunk=2)
        want = dock_sweep_resplat(H, coords, types, mask, rots,
                                  _identity_rep, **kw)
        mesh = make_mesh(rot=8)
        got = sharded_dock_sweep_resplat(mesh, H, coords, types, mask,
                                         rots, _identity_rep, **kw)
        np.testing.assert_allclose(np.asarray(got.scores),
                                   np.asarray(want.scores), rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(got.rot_idx),
                                      np.asarray(want.rot_idx))

    def test_auto_ligand_grid(self):
        coords = np.random.default_rng(0).uniform(-6, 6, (20, 3))
        ls = auto_ligand_grid(coords, resolution=1.0, sigma=1.0,
                              receptive_field=3, grid_size=64)
        assert ls % 8 == 0 and 16 <= ls <= 64
        # Must cover atoms + tails + receptive field.
        assert ls >= (2 * (6 + 3) / 1.0 + 2 * 3) * 0.9

    def test_auto_ligand_grid_rotation_invariant_containment(self):
        # An elongated ligand lying along the box diagonal: its
        # per-axis extent in the given orientation is small, but under
        # rotation inside the box its L2 radius can swing past a
        # per-axis-sized boundary.  The box must satisfy
        # Ls * res / 2 >= max||x|| + 3 sigma for EVERY rotation.
        rng = np.random.default_rng(1)
        t = rng.uniform(-1, 1, (30, 1))
        coords = t * np.array([[7.0, 7.0, 7.0]]) \
            + rng.normal(0, 0.3, (30, 3))          # rod along diagonal
        res, sigma = 1.0, 1.0
        ls = auto_ligand_grid(coords, resolution=res, sigma=sigma,
                              receptive_field=0, grid_size=128)
        radius = float(np.sqrt((coords ** 2).sum(axis=1).max()))
        assert ls * res / 2.0 >= radius + 3.0 * sigma
        # and the rotated per-axis extent indeed exceeds the naive
        # per-axis bound this test exists to guard against
        naive = 2.0 * (np.abs(coords).max() + 3.0 * sigma)
        assert 2.0 * (radius + 3.0 * sigma) > naive

    def test_gradients_flow_through_resplat_path(self):
        # "grads through voxelizer + FFT correlator" — for real now:
        # d score / d atom coords through splat -> FFT -> gather.
        L = 16
        coords, types, mask = _atoms(n=6, spread=2.0)
        rec = separable_splat(coords + 1.0, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        H = receptor_transform(rec)

        def f(c):
            s = score_decoys_resplat(
                H, c, types, mask, jnp.eye(3)[None],
                jnp.array([[1, 0, -1]]), _identity_rep, grid_size=L,
                lig_grid=12, resolution=1.0, sigma=1.0, num_types=4)
            return s[0]

        g = jax.grad(f)(coords)
        assert np.isfinite(np.asarray(g)).all()
        eps = 1e-2
        e = jnp.zeros_like(coords).at[0, 0].set(1.0)
        fd = (f(coords + eps * e) - f(coords - eps * e)) / (2 * eps)
        np.testing.assert_allclose(float((g * e).sum()), float(fd),
                                   rtol=5e-2, atol=1e-3)


class TestRefine:
    def test_recovers_subvoxel_shift(self):
        from deeplocalproteindocking_tpu.sweep.refine import (
            continuous_score, refine_poses)
        L, Ls = 16, 12
        coords, types, mask = _atoms(n=10, spread=2.5)
        t_true = jnp.array([1.4, -0.6, 2.3])   # fractional voxels
        rec = separable_splat(coords + t_true, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        H = receptor_transform(rec)
        kw = dict(grid_size=L, lig_grid=Ls, resolution=1.0, sigma=1.0,
                  num_types=4)
        # Coarse sweep snaps to the nearest voxel.
        res = dock_sweep_resplat(H, coords, types, mask,
                                 jnp.eye(3)[None], _identity_rep,
                                 top_k=1, chunk=1, **kw)
        np.testing.assert_array_equal(np.asarray(res.shifts[0]),
                                      [1, -1, 2])
        out = refine_poses(H, coords, types, mask,
                           jnp.eye(3)[None], res.shifts[:1],
                           _identity_rep, steps=60, lr=0.05, **kw)
        assert float(out.scores[0]) >= float(out.initial_scores[0])
        t_ref = np.asarray(out.translations[0])   # resolution=1 -> voxels
        np.testing.assert_allclose(t_ref, np.asarray(t_true), atol=0.25)

    def test_continuous_matches_lattice_score(self):
        from deeplocalproteindocking_tpu.sweep.refine import (
            continuous_score)
        from deeplocalproteindocking_tpu.sweep.resplat import (
            score_decoys_resplat)
        L, Ls = 16, 12
        coords, types, mask = _atoms(n=8, spread=2.5)
        rec = separable_splat(coords + 1.0, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        H = receptor_transform(rec)
        kw = dict(grid_size=L, lig_grid=Ls, resolution=1.0, sigma=1.0,
                  num_types=4)
        shift = jnp.array([2, -1, 3])
        want = score_decoys_resplat(H, coords, types, mask,
                                    jnp.eye(3)[None], shift[None],
                                    _identity_rep, **kw)[0]
        got = continuous_score(H, coords, types, mask, jnp.eye(3),
                               shift.astype(jnp.float32),
                               _identity_rep, **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)

    def test_block_score_matches_lattice(self):
        # Spectrum-free real-space score (block engine) == FFT lattice
        # score at integer shifts, including wrapped (negative) ones.
        from deeplocalproteindocking_tpu.sweep.refine import (
            continuous_score_block)
        from deeplocalproteindocking_tpu.sweep.resplat import (
            score_decoys_resplat)
        L, Ls = 16, 12
        coords, types, mask = _atoms(n=8, spread=2.5)
        rec = separable_splat(coords + 1.0, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        H = receptor_transform(rec)
        kw = dict(grid_size=L, lig_grid=Ls, resolution=1.0, sigma=1.0,
                  num_types=4)
        for shift in ([2, -1, 3], [-5, 4, -2]):
            shift = jnp.asarray(shift)
            want = score_decoys_resplat(H, coords, types, mask,
                                        jnp.eye(3)[None], shift[None],
                                        _identity_rep, **kw)[0]
            got = continuous_score_block(
                rec, coords, types, mask, jnp.eye(3),
                shift.astype(jnp.float32), _identity_rep, **kw)
            np.testing.assert_allclose(float(got), float(want),
                                       rtol=1e-4)

    def test_block_refine_recovers_subvoxel_shift(self):
        # The block-engine refinement path (real-space patch score, no
        # spectrum) recovers a fractional translation like the
        # spectral path does.
        from deeplocalproteindocking_tpu.sweep.refine import refine_poses
        L, Ls = 16, 12
        coords, types, mask = _atoms(n=10, spread=2.5)
        t_true = jnp.array([1.4, -0.6, 2.3])
        rec = separable_splat(coords + t_true, types, mask, grid_size=L,
                              resolution=1.0, num_types=4)
        kw = dict(grid_size=L, lig_grid=Ls, resolution=1.0, sigma=1.0,
                  num_types=4)
        out = refine_poses(rec, coords, types, mask,
                           jnp.eye(3)[None],
                           jnp.array([[1, -1, 2]]),
                           _identity_rep, steps=60, lr=0.05,
                           fft_impl="block", **kw)
        assert float(out.scores[0]) >= float(out.initial_scores[0])
        t_ref = np.asarray(out.translations[0])
        np.testing.assert_allclose(t_ref, np.asarray(t_true), atol=0.3)


class TestSE3Consistency:
    def test_joint_rotation_invariance_shape_mode(self):
        # Rotating BOTH receptor and ligand by the same R permutes the
        # score landscape but preserves the best score (up to grid
        # effects); exact for 90-degree lattice rotations.
        L = 16
        coords_r, types_r, mask_r = _atoms(n=10, seed=5, spread=2.5)
        coords_l, types_l, mask_l = _atoms(n=8, seed=6, spread=2.0)
        R = axis_angle_to_matrix(jnp.array([0.0, 0.0, 1.0]),
                                 jnp.array(np.pi / 2))
        kw = dict(grid_size=L, lig_grid=12, resolution=1.0, sigma=1.0,
                  num_types=4, top_k=1, chunk=1)

        def best(rc, lc):
            rec = separable_splat(rc, types_r, mask_r, grid_size=L,
                                  resolution=1.0, num_types=4)
            H = receptor_transform(rec)
            res = dock_sweep_resplat(H, lc, types_l, mask_l,
                                     jnp.eye(3)[None], _identity_rep,
                                     **kw)
            return float(res.scores[0]), np.asarray(res.shifts[0])

        s0, t0 = best(coords_r, coords_l)
        s1, t1 = best(rotate(coords_r, R), rotate(coords_l, R))
        np.testing.assert_allclose(s1, s0, rtol=1e-3)
        # Best translation rotates with the frame.
        np.testing.assert_allclose(np.asarray(R) @ t0, t1, atol=0.51)
