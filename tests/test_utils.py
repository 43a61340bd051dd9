"""Config, logging and profiling utilities."""
import json
import time

import numpy as np

from deeplocalproteindocking_tpu.config import DockConfig, PRESETS
from deeplocalproteindocking_tpu.utils.logging import MetricsLogger
from deeplocalproteindocking_tpu.utils.profiling import StageTimer


class TestConfig:
    def test_json_roundtrip(self):
        cfg = DockConfig(grid_size=96, rep_features=(8, 4),
                         sweep_mode="resample", local_cone_deg=15.0)
        cfg2 = DockConfig.from_json(cfg.to_json())
        assert cfg2 == cfg
        assert cfg2.rep_features == (8, 4)

    def test_presets_cover_baseline_configs(self):
        # The five BASELINE.json configs map to five named presets.
        assert set(PRESETS) == {"tiny-shape", "rep-score", "full-sweep",
                                "train", "benchmark-4gpu"}
        assert PRESETS["full-sweep"].num_rotations == 13000
        assert PRESETS["benchmark-4gpu"].mesh_rot == 4

    def test_replace(self):
        cfg = DockConfig()
        assert cfg.replace(grid_size=32).grid_size == 32
        assert cfg.grid_size == 128  # frozen original

    def test_properties(self):
        cfg = DockConfig(grid_size=64, resolution=1.5,
                         rep_features=(8, 4))
        assert cfg.c_rep == 4
        assert cfg.box_extent == 96.0


class TestLogging:
    def test_jsonl_written(self, tmp_path):
        path = tmp_path / "m.jsonl"
        with MetricsLogger(str(path), echo=False) as log:
            log.log("train_step", step=1, loss=np.float32(0.5))
            log.log("eval", hit=True)
        lines = [json.loads(l) for l in path.read_text().splitlines()]
        assert len(lines) == 2
        assert lines[0]["event"] == "train_step"
        assert abs(lines[0]["loss"] - 0.5) < 1e-6   # np scalar unboxed
        assert lines[1]["hit"] is True
        assert "time" in lines[0]

    def test_no_path_echo_only(self, capsys):
        log = MetricsLogger(None, echo=True)
        log.log("x", v=1)
        assert '"v": 1' in capsys.readouterr().out


class TestProfiling:
    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("a"):
            time.sleep(0.01)
        with t.stage("a"):
            time.sleep(0.01)
        assert t.times["a"] >= 0.02


class TestScalableGrading:
    """Chunked grading for real protein sizes (round-2 VERDICT #4)."""

    def _random_complex(self, n_rec, n_lig, seed=0, atoms_per_res=8):
        import numpy as np
        rng = np.random.default_rng(seed)
        rec = rng.normal(size=(n_rec, 3)).astype(np.float32) * 12.0
        lig = (rng.normal(size=(n_lig, 3)).astype(np.float32) * 7.0
               + np.array([18.0, 0, 0], np.float32))
        rec_res = (np.arange(n_rec) // atoms_per_res).astype(np.int32)
        lig_res = (np.arange(n_lig) // atoms_per_res).astype(np.int32)
        return rec, lig, rec_res, lig_res

    def test_contact_table_matches_dense(self):
        import jax.numpy as jnp
        import numpy as np
        from deeplocalproteindocking_tpu.utils.quality import (
            residue_contact_table)
        rec, lig, rec_res, lig_res = self._random_complex(200, 90)
        nr, nl = rec_res.max() + 1, lig_res.max() + 1
        # dense oracle
        d2 = ((rec[:, None] - lig[None]) ** 2).sum(-1)
        am = d2 < 25.0
        dense = np.zeros((nr, nl), bool)
        for i in range(len(rec)):
            for j in np.nonzero(am[i])[0]:
                dense[rec_res[i], lig_res[j]] = True
        tab = residue_contact_table(
            jnp.asarray(rec), jnp.asarray(lig), jnp.asarray(rec_res),
            jnp.asarray(lig_res), num_rec_res=int(nr),
            num_lig_res=int(nl), atom_chunk=64)
        np.testing.assert_array_equal(np.asarray(tab), dense)

    def test_interface_masks_match_dense(self):
        import jax.numpy as jnp
        import numpy as np
        from deeplocalproteindocking_tpu.utils.quality import (
            interface_masks, interface_masks_chunked)
        rec, lig, _, _ = self._random_complex(300, 120, seed=1)
        a_r, a_l = interface_masks(jnp.asarray(rec), jnp.asarray(lig))
        b_r, b_l = interface_masks_chunked(
            jnp.asarray(rec), jnp.asarray(lig), atom_chunk=128)
        np.testing.assert_array_equal(np.asarray(a_r), np.asarray(b_r))
        np.testing.assert_array_equal(np.asarray(a_l), np.asarray(b_l))

    def test_grade_poses_parity_small(self):
        """grade_poses (chunked path) == dense per-pose metrics."""
        import jax.numpy as jnp
        import numpy as np
        from deeplocalproteindocking_tpu.data import synthetic_complex
        from deeplocalproteindocking_tpu.evaluation import grade_poses
        from deeplocalproteindocking_tpu.pipeline import PoseSet
        from deeplocalproteindocking_tpu.structure.transforms import (
            apply_pose)
        from deeplocalproteindocking_tpu.utils.quality import (
            fnat, interface_rmsd, ligand_rmsd)
        from deeplocalproteindocking_tpu.evaluation import _dense_res_ids
        cplx = synthetic_complex(seed=6, n_res_rec=10, n_res_lig=5)
        K = 5
        rng = np.random.default_rng(0)
        Rs = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        ts = rng.normal(size=(K, 3)).astype(np.float32) * 3.0
        poses = PoseSet(scores=np.zeros(K, np.float32), rotations=Rs,
                        translations=ts,
                        rot_idx=np.zeros(K, np.int32),
                        shifts=np.zeros((K, 3), np.int32))
        graded = grade_poses(cplx, poses)
        rec = jnp.asarray(cplx.receptor.centered().coords)
        native = jnp.asarray(cplx.ligand.coords - cplx.receptor.center)
        rr = _dense_res_ids(cplx.receptor)
        lr = _dense_res_ids(cplx.ligand)
        lig_c = jnp.asarray(cplx.ligand.centered().coords)
        for i, g in enumerate(graded):
            p = apply_pose(lig_c, jnp.asarray(Rs[i]),
                           jnp.asarray(ts[i]))
            assert abs(g["lrmsd"]
                       - float(ligand_rmsd(p, native))) < 1e-4
            assert abs(g["irmsd"]
                       - float(interface_rmsd(rec, native, p))) < 1e-4
            assert abs(g["fnat"] - float(
                fnat(rec, native, p, jnp.asarray(rr), jnp.asarray(lr),
                     num_rec_res=int(rr.max()) + 1,
                     num_lig_res=int(lr.max()) + 1))) < 1e-5

    def test_large_complex_many_poses(self):
        """>=5k-atom complex graded with K=64 poses in one call —
        the scale gate for real Docking Benchmark data (VERDICT #4).
        Peak pairwise intermediate is atom_chunk*N_lig, not
        N_rec*N_lig*K (~5e9 floats dense)."""
        import numpy as np
        from deeplocalproteindocking_tpu.data.benchmark import Complex
        from deeplocalproteindocking_tpu.evaluation import grade_poses
        from deeplocalproteindocking_tpu.pipeline import PoseSet
        from deeplocalproteindocking_tpu.structure.pdb import Structure
        from deeplocalproteindocking_tpu.structure.atom_types import (
            assign_atom_types)

        def struct(n_atoms, seed, chain):
            rng = np.random.default_rng(seed)
            coords = rng.normal(size=(n_atoms, 3)).astype(np.float32) * 20
            names = np.full(n_atoms, "CA", dtype="<U4")
            ress = np.full(n_atoms, "ALA", dtype="<U3")
            rids = (np.arange(n_atoms) // 8 + 1).astype(np.int32)
            return Structure(
                coords=coords, atom_names=names, res_names=ress,
                res_ids=rids,
                chain_ids=np.full(n_atoms, chain, dtype="<U1"),
                types=assign_atom_types(ress, names))

        cplx = Complex(name="big", receptor=struct(4000, 0, "A"),
                       ligand=struct(1500, 1, "B"))
        K = 64
        rng = np.random.default_rng(2)
        poses = PoseSet(
            scores=np.zeros(K, np.float32),
            rotations=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
            translations=rng.normal(size=(K, 3)).astype(np.float32) * 5,
            rot_idx=np.zeros(K, np.int32),
            shifts=np.zeros((K, 3), np.int32))
        graded = grade_poses(cplx, poses)
        assert len(graded) == K
        assert all(np.isfinite(g["lrmsd"]) and np.isfinite(g["irmsd"])
                   and 0.0 <= g["fnat"] <= 1.0 for g in graded)


class TestCCP4Export:
    def test_roundtrip(self, tmp_path):
        import numpy as np
        from deeplocalproteindocking_tpu.grids.ccp4 import (
            read_ccp4, write_ccp4)
        rng = np.random.default_rng(0)
        vol = rng.normal(size=(16, 16, 16)).astype(np.float32)
        p = str(tmp_path / "m.ccp4")
        write_ccp4(p, vol, resolution=1.25)
        back, res = read_ccp4(p)
        np.testing.assert_array_equal(back, vol)
        assert abs(res - 1.25) < 1e-6
        # header sanity: 1024 + data bytes
        import os
        assert os.path.getsize(p) == 1024 + 4 * 16 ** 3

    def test_rejects_non_cubic(self, tmp_path):
        import numpy as np
        import pytest
        from deeplocalproteindocking_tpu.grids.ccp4 import write_ccp4
        with pytest.raises(ValueError):
            write_ccp4(str(tmp_path / "x.ccp4"),
                       np.zeros((8, 8, 4), np.float32))
