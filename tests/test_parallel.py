"""Multi-device semantics on the virtual 8-CPU mesh (SURVEY.md §4):
the same shard_map code paths that run on a multi-GPU host."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.data import synthetic_complex
from deeplocalproteindocking_tpu.parallel import (
    make_mesh, make_parallel_train_step, sharded_dock_sweep,
)
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations,
)
from deeplocalproteindocking_tpu.sweep import dock_sweep
from deeplocalproteindocking_tpu.train import Trainer
from deeplocalproteindocking_tpu.train.data_gen import make_training_batch


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


class TestShardedSweep:
    def test_matches_single_device(self):
        L, C = 12, 2
        rng = np.random.default_rng(0)
        rec = jnp.asarray(rng.normal(size=(L, L, L, C)).astype(np.float32))
        lig = jnp.asarray(rng.normal(size=(L, L, L, C)).astype(np.float32))
        A = jnp.asarray(rng.normal(size=(C, C)).astype(np.float32))
        rots = super_fibonacci_rotations(24)
        mesh = make_mesh(rot=8)
        got = sharded_dock_sweep(mesh, rec, lig, rots, A, top_k=8, chunk=2)
        want = dock_sweep(rec, lig, rots, A, top_k=8, chunk=2)
        np.testing.assert_allclose(np.asarray(got.scores),
                                   np.asarray(want.scores), rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(got.rot_idx),
                                      np.asarray(want.rot_idx))
        np.testing.assert_array_equal(np.asarray(got.shifts),
                                      np.asarray(want.shifts))

    def test_uneven_rotation_count(self):
        # 13 rotations over 8 shards: padding must stay masked.
        L = 8
        rng = np.random.default_rng(1)
        rec = jnp.asarray(rng.normal(size=(L, L, L, 1)).astype(np.float32))
        lig = jnp.asarray(rng.normal(size=(L, L, L, 1)).astype(np.float32))
        rots = super_fibonacci_rotations(13)
        mesh = make_mesh(rot=8)
        got = sharded_dock_sweep(mesh, rec, lig, rots, top_k=16, chunk=2)
        want = dock_sweep(rec, lig, rots, top_k=16, chunk=2)
        np.testing.assert_allclose(np.asarray(got.scores),
                                   np.asarray(want.scores), rtol=1e-4)
        assert int(got.rot_idx.max()) < 13


class TestParallelTrain:
    def test_matches_single_device_grads(self):
        cfg = DockConfig(grid_size=16, resolution=1.5, rep_features=(4,),
                         num_decoys=8, batch_complexes=2,
                         decoy_max_shift=3.0)
        trainer = Trainer(cfg)
        state = trainer.init_state()
        cplxs = [synthetic_complex(seed=s, n_res_rec=5, n_res_lig=3)
                 for s in range(2)]
        batch = make_training_batch(jax.random.key(0), cplxs, cfg)

        mesh = make_mesh(rot=4, batch=2)
        pstep = make_parallel_train_step(trainer, mesh)
        pstate, pmetrics = pstep(state, batch)
        sstate, smetrics = trainer.train_step(state, batch)

        np.testing.assert_allclose(float(pmetrics["loss"]),
                                   float(smetrics["loss"]), rtol=1e-4)
        for a, b in zip(jax.tree.leaves(pstate.params),
                        jax.tree.leaves(sstate.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=2e-5)

    def test_pipeline_with_mesh(self):
        from deeplocalproteindocking_tpu.pipeline import DockingPipeline
        cfg = DockConfig(grid_size=24, resolution=1.5, num_rotations=16,
                         rotation_chunk=2, top_k=8, rep_features=(4,))
        cplx = synthetic_complex(seed=7, n_res_rec=8, n_res_lig=4)
        mesh = make_mesh(rot=8)
        poses_sharded = DockingPipeline(config=cfg, mesh=mesh).dock_complex(
            cplx, cluster=False)
        poses_single = DockingPipeline(config=cfg).dock_complex(
            cplx, cluster=False)
        np.testing.assert_allclose(poses_sharded.scores,
                                   poses_single.scores, rtol=1e-4)
        np.testing.assert_array_equal(poses_sharded.rot_idx,
                                      poses_single.rot_idx)


class TestBatchEval:
    def _setup(self, B=4):
        from deeplocalproteindocking_tpu.correlate import receptor_transform
        from deeplocalproteindocking_tpu.grids.voxelize import separable_splat
        L, Ls, C = 16, 12, 3
        rng = np.random.default_rng(0)
        H, lc, lt, lm = [], [], [], []
        for b in range(B):
            coords = jnp.asarray(
                rng.uniform(-2.5, 2.5, (8, 3)).astype(np.float32))
            types = jnp.asarray(rng.integers(0, C, 8).astype(np.int32))
            mask = jnp.ones(8)
            rec = separable_splat(coords + 1.0, types, mask, grid_size=L,
                                  resolution=1.0, num_types=C)
            H.append(receptor_transform(rec))
            lc.append(coords); lt.append(types); lm.append(mask)
        return (jnp.stack(H), jnp.stack(lc), jnp.stack(lt),
                jnp.stack(lm), L, Ls, C)

    def test_batched_matches_loop(self):
        from deeplocalproteindocking_tpu.parallel.batch_eval import dock_batch
        from deeplocalproteindocking_tpu.sweep.resplat import (
            dock_sweep_resplat)
        H, lc, lt, lm, L, Ls, C = self._setup()
        rots = super_fibonacci_rotations(6)
        rep = lambda v: v
        kw = dict(grid_size=L, lig_grid=Ls, resolution=1.0, sigma=1.0,
                  num_types=C, top_k=4, chunk=2)
        got = dock_batch(None, H, lc, lt, lm, rots, rep, **kw)
        for b in range(H.shape[0]):
            want = dock_sweep_resplat(H[b], lc[b], lt[b], lm[b], rots,
                                      rep, **kw)
            np.testing.assert_allclose(np.asarray(got.scores[b]),
                                       np.asarray(want.scores), rtol=1e-4)
            np.testing.assert_array_equal(np.asarray(got.rot_idx[b]),
                                          np.asarray(want.rot_idx))

    def test_mesh_2d_matches_unsharded(self):
        from deeplocalproteindocking_tpu.parallel.batch_eval import dock_batch
        H, lc, lt, lm, L, Ls, C = self._setup(B=4)
        rots = super_fibonacci_rotations(7)  # uneven over rot shards
        rep = lambda v: v
        kw = dict(grid_size=L, lig_grid=Ls, resolution=1.0, sigma=1.0,
                  num_types=C, top_k=4, chunk=2)
        want = dock_batch(None, H, lc, lt, lm, rots, rep, **kw)
        mesh = make_mesh(rot=4, batch=2)
        got = dock_batch(mesh, H, lc, lt, lm, rots, rep, **kw)
        np.testing.assert_allclose(np.asarray(got.scores),
                                   np.asarray(want.scores), rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(got.rot_idx),
                                      np.asarray(want.rot_idx))
        np.testing.assert_array_equal(np.asarray(got.shifts),
                                      np.asarray(want.shifts))
