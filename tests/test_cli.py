"""CLI smoke tests (reference P10) — full command flows on tiny configs."""
import json
import os

from deeplocalproteindocking_tpu.cli import main


class TestCLI:
    def test_generate_dock_evaluate(self, tmp_path):
        db = str(tmp_path / "db")
        main(["generate-dataset", "--out", db, "--num-complexes", "2"])
        assert len(os.listdir(db)) == 4

        poses = str(tmp_path / "poses")
        main(["dock", "--receptor", f"{db}/synth0_r_u.pdb",
              "--ligand", f"{db}/synth0_l_u.pdb", "--out", poses,
              "--grid-size", "32", "--num-rotations", "8",
              "--top-k", "8", "--num-out", "2"])
        table = json.load(open(os.path.join(poses, "poses.json")))
        assert len(table) >= 1 and "score" in table[0]
        assert os.path.exists(os.path.join(poses, "pose_000.pdb"))

        out = str(tmp_path / "bench")
        main(["evaluate", "--synthetic", "1", "--out", out,
              "--grid-size", "32", "--num-rotations", "8",
              "--top-k", "8"])
        summary = json.load(open(os.path.join(out, "summary.json")))
        assert summary["num_complexes"] == 1

    def test_train_and_dock_with_checkpoint(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        main(["train", "--ckpt-dir", ckpt, "--steps", "2",
              "--synthetic", "2", "--grid-size", "32",
              "--resolution", "2.0", "--ckpt-every", "2"])
        assert any(d.startswith("step_") for d in os.listdir(ckpt))
        db = str(tmp_path / "db")
        main(["generate-dataset", "--out", db, "--num-complexes", "1"])
        poses = str(tmp_path / "poses2")
        main(["dock", "--receptor", f"{db}/synth0_r_u.pdb",
              "--ligand", f"{db}/synth0_l_u.pdb", "--out", poses,
              "--checkpoint", ckpt, "--grid-size", "32",
              "--resolution", "2.0",
              "--num-rotations", "4", "--top-k", "4"])
        assert os.path.exists(os.path.join(poses, "poses.json"))

    def test_screen_command(self, tmp_path):
        db = str(tmp_path / "db")
        main(["generate-dataset", "--out", db, "--num-complexes", "2",
              "--backbone"])
        out = str(tmp_path / "scr")
        main(["screen", "--receptor", f"{db}/synth0_r_u.pdb",
              "--ligands",
              f"{db}/synth0_l_u.pdb,{db}/synth1_l_u.pdb",
              "--out", out, "--grid-size", "32",
              "--num-rotations", "4", "--top-k", "4"])
        res = json.load(open(os.path.join(out, "screen.json")))
        assert len(res["ranking"]) == 2
        # receptor prepared once, second ligand served from cache
        assert res["cache"]["misses"] == 1
        assert res["cache"]["hits"] == 1
        scores = [r["best_score"] for r in res["ranking"]]
        assert scores == sorted(scores, reverse=True)

    def test_generate_dataset_decoys(self, tmp_path):
        import numpy as np
        db = str(tmp_path / "db")
        main(["generate-dataset", "--out", db, "--num-complexes", "1",
              "--decoys", "8"])
        z = np.load(os.path.join(db, "synth0_decoys.npz"))
        assert z["rotations"].shape == (8, 3, 3)
        assert z["shifts"].shape == (8, 3)
        assert z["lrmsd"].shape == (8,)
        assert z["lrmsd"][0] < 1e-4      # decoy 0 is the native pose

    def test_doctor_and_info_never_hang(self, capsys):
        # doctor/info query the devices in this process and report the
        # backend, native libs and compile cache.
        rc = main(["doctor"])
        out = capsys.readouterr().out
        assert '"doctor_ok": true' in out
        assert "native pdb_native" in out
        assert rc == 0
        main(["info"])
        out = capsys.readouterr().out
        assert "presets:" in out and "devices:" in out
