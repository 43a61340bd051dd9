"""Smoke test of the main paths on a GPU, at full width.

    python chip_smoke.py            # phases 1-4 on one GPU
    python chip_smoke.py --four     # the 4-GPU paths only

Phases (one process; each prints one result line):

1. ``cli dock --checkpoint pretrained/synthetic-v9p/best`` on a
   synthetic polymer complex written to PDB (the flagship: hybrid, 16
   correlation channels, grid 64, 13 000 rotations); poses are written.
2. The full 13 000-rotation x 128^3 sweep through
   ``DockingPipeline.dock`` with the flagship weights, full rank and
   rank 3; wall-clock and rotations/s.
3. The reference check: the ``dft`` sweep against the plain ``jnp.fft``
   reference (``sweep/reference.py``) over 512 rotations at 128^3, full
   rank, tolerance 1e-4 * max|S|.
4. ``cli train --preset train --steps 3`` (grid 96, gradients through
   splat, CNN and correlator); the loss is finite and the checkpoint
   restores.

``--four`` (needs four GPUs): the rotation-sharded sweep equals the
one-GPU sweep, the batched evaluation on a (rot=2, batch=2) mesh equals
the sequential hit rates, and one data/decoy-parallel train step equals
the one-device loss.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  The last line is one JSON object with the device JAX reports.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "pretrained", "synthetic-v9p", "best")


def _complex(seed, n_rec, n_lig):
    from deeplocalproteindocking_tpu.data import synthetic_complex
    return synthetic_complex(seed=seed, n_res_rec=n_rec, n_res_lig=n_lig,
                             unbound_rmsd=1.2, backbone=True)


def _flagship(**over):
    """(config, params) of the flagship checkpoint, config overridden."""
    from deeplocalproteindocking_tpu.config import DockConfig
    from deeplocalproteindocking_tpu.train import Trainer
    with open(os.path.join(FLAGSHIP, "config.json")) as f:
        cfg = DockConfig.from_json(f.read()).replace(**over)
    return cfg, Trainer(cfg).restore(FLAGSHIP).params


def phase_dock_cli(work, n_rec=40, n_lig=20, extra=()):
    from deeplocalproteindocking_tpu import cli
    from deeplocalproteindocking_tpu.structure.pdb import write_pdb
    c = _complex(11, n_rec, n_lig)
    rec, lig = os.path.join(work, "rec.pdb"), os.path.join(work, "lig.pdb")
    write_pdb(rec, c.receptor)
    write_pdb(lig, c.ligand)
    out = os.path.join(work, "dock_out")
    t0 = time.perf_counter()
    cli.main(["dock", "--receptor", rec, "--ligand", lig, "--out", out,
              "--checkpoint", FLAGSHIP, *extra])
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "poses.json")) as f:
        poses = json.load(f)
    pdbs = [p for p in os.listdir(out) if p.startswith("pose_")]
    scores = np.array([p["score"] for p in poses])
    assert len(poses) > 0 and pdbs, "no poses written"
    assert np.isfinite(scores).all(), "non-finite pose scores"
    return dict(poses=len(poses), pose_pdbs=len(pdbs), seconds=wall,
                best_score=float(scores[0]))


def phase_full_sweep(n_rot=13000, grid=128, n_rec=60, n_lig=30,
                     ranks=(None, 3)):
    from deeplocalproteindocking_tpu.config import FULL_SWEEP_CHUNK
    from deeplocalproteindocking_tpu.pipeline import DockingPipeline
    c = _complex(12, n_rec, n_lig)
    out = {}
    for rank in ranks:
        cfg, params = _flagship(
            grid_size=grid, num_rotations=n_rot, lig_grid_size=None,
            rotation_chunk=min(FULL_SWEEP_CHUNK, n_rot), top_k=64,
            coupling_rank=rank)
        pipe = DockingPipeline(config=cfg, params=params)
        t0 = time.perf_counter()
        pipe.dock(c.receptor, c.ligand)          # compiles
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        poses = pipe.dock(c.receptor, c.ligand)
        wall = time.perf_counter() - t0
        assert len(poses) > 0 and np.isfinite(poses.scores).all()
        out[f"rank{rank or 'full'}"] = dict(
            seconds=wall, rotations_per_second=n_rot / wall,
            first_call_seconds=first, poses=len(poses),
            chunk=cfg.rotation_chunk)
    return out


def sweep_case(grid=128, n_rec=60, n_lig=30, **over):
    """(pipe, prep, lig, kw): the flagship and a synthetic complex,
    prepared for ``dock_sweep_resplat`` (top-64; ``over`` overrides
    the config)."""
    from deeplocalproteindocking_tpu.data.benchmark import (
        structure_to_device)
    from deeplocalproteindocking_tpu.pipeline import DockingPipeline
    from deeplocalproteindocking_tpu.sweep.resplat import auto_ligand_grid
    c = _complex(12, n_rec, n_lig)
    cfg, params = _flagship(**{**dict(grid_size=grid, lig_grid_size=None,
                                      top_k=64), **over})
    pipe = DockingPipeline(config=cfg, params=params)
    prep = pipe._prepare(c.receptor, c.ligand)
    lig_c = prep[1]
    lig = structure_to_device(lig_c, bucket=cfg.atom_bucket)
    lig_grid = auto_ligand_grid(lig_c.typed().coords, cfg.resolution,
                                cfg.sigma, pipe._receptive_field(), grid)
    kw = dict(grid_size=grid, lig_grid=lig_grid, resolution=cfg.resolution,
              sigma=cfg.sigma, num_types=cfg.num_atom_types, top_k=64)
    return pipe, prep, lig, kw


def reference_check(n_rot=512, grid=128, n_rec=60, n_lig=30, chunk=None,
                    dft_dtype="float32"):
    """The dft sweep vs the jnp.fft reference; returns the agreement."""
    import jax.numpy as jnp
    from deeplocalproteindocking_tpu.config import FULL_SWEEP_CHUNK
    from deeplocalproteindocking_tpu.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_tpu.sweep.reference import (
        reference_sweep, topk_agreement)
    from deeplocalproteindocking_tpu.sweep.resplat import (
        dock_sweep_resplat)
    pipe, prep, lig, kw = sweep_case(grid, n_rec, n_lig,
                                     coupling_rank=None,
                                     dft_dtype=dft_dtype)
    _, _, rep_rec, _, coupling = prep
    impl, H, rep_fn = pipe._engine_parts(rep_rec, coupling)
    rots = super_fibonacci_rotations(n_rot)
    ref, smax, score_at = reference_sweep(H, *lig, rots, rep_fn, **kw)
    got = dock_sweep_resplat(H, *lig, rots, rep_fn, fft_impl=impl,
                             dft_dtype=dft_dtype,
                             chunk=chunk or FULL_SWEEP_CHUNK, **kw)
    agree = topk_agreement(ref, got, 1e-4 * smax, score_at)
    agree.update(engine=impl, dft_dtype=dft_dtype, max_abs_S=smax,
                 lig_grid=kw["lig_grid"], rotations=n_rot,
                 top1_score_ref=float(jnp.asarray(ref.scores)[0]))
    return agree


def phase_reference(**kw):
    agree = reference_check(**kw)
    assert agree["ok"], f"dft sweep disagrees with the reference: {agree}"
    return agree


def phase_train(work, steps=3, extra=()):
    from deeplocalproteindocking_tpu import cli
    from deeplocalproteindocking_tpu.config import PRESETS
    from deeplocalproteindocking_tpu.train import Trainer
    ckpt = os.path.join(work, "train_ckpt")
    t0 = time.perf_counter()
    cli.main(["train", "--preset", "train", "--steps", str(steps),
              "--ckpt-dir", ckpt, "--synthetic", "4", *extra])
    wall = time.perf_counter() - t0
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if r.get("event") == "train_step"]
    assert len(losses) == steps, recs
    assert np.isfinite(losses).all(), f"non-finite loss {losses}"
    with open(os.path.join(ckpt, "config.json")) as f:
        from deeplocalproteindocking_tpu.config import DockConfig
        cfg = DockConfig.from_json(f.read())
    state = Trainer(cfg).restore(ckpt)
    assert int(state.step) == steps
    return dict(losses=losses, seconds=wall,
                grid=PRESETS["train"].grid_size)


def phase_four(work, n_rot=4096, grid=128, eval_rot=1024, n_eval=4,
               n_rec=60, n_lig=30, train_grid=None):
    import jax
    from deeplocalproteindocking_tpu.config import PRESETS
    from deeplocalproteindocking_tpu.evaluation import (
        run_benchmark, run_benchmark_batched)
    from deeplocalproteindocking_tpu.parallel import (
        make_mesh, make_parallel_train_step)
    from deeplocalproteindocking_tpu.pipeline import DockingPipeline
    from deeplocalproteindocking_tpu.train import Trainer
    from deeplocalproteindocking_tpu.train.data_gen import (
        fit_lig_grid, make_training_batch)
    out = {}
    # (a) rotation-sharded sweep == one-device sweep.
    c = _complex(12, n_rec, n_lig)
    cfg, params = _flagship(grid_size=grid, num_rotations=n_rot,
                            lig_grid_size=None, top_k=64, coupling_rank=3)
    one = DockingPipeline(config=cfg, params=params).dock(
        c.receptor, c.ligand, cluster=False)
    four = DockingPipeline(config=cfg, params=params,
                           mesh=make_mesh(rot=4)).dock(
        c.receptor, c.ligand, cluster=False)
    tol = 1e-5 * float(np.abs(one.scores).max())
    np.testing.assert_allclose(four.scores, one.scores, rtol=0, atol=tol)
    # Same poses, except ties at the K-th score.
    kth = float(one.scores[-1])
    poses = [{(int(r), tuple(int(v) for v in s)): float(x)
              for r, s, x in zip(p.rot_idx, p.shifts, p.scores)}
             for p in (one, four)]
    differ = set(poses[0]).symmetric_difference(poses[1])
    assert all(abs({**poses[0], **poses[1]}[p] - kth) <= tol
               for p in differ), "sharded sweep found other poses"
    out["rot_sharded_sweep"] = dict(rotations=n_rot, grid=grid,
                                    top_k=len(one), equal=True)
    # (b) batched evaluation on a (rot=2, batch=2) mesh == sequential.
    cplxs = [_complex(300 + i, 16, 8) for i in range(n_eval)]
    ecfg, _ = _flagship(num_rotations=eval_rot, top_k=32)
    seq = run_benchmark(DockingPipeline(config=ecfg, params=params),
                        cplxs, os.path.join(work, "seq"))
    bat = run_benchmark_batched(
        DockingPipeline(config=ecfg, params=params,
                        mesh=make_mesh(rot=2, batch=2)),
        cplxs, os.path.join(work, "bat"), group_size=n_eval)
    for k in ("top1_hit_rate", "top10_hit_rate"):
        assert seq[k] == bat[k], (seq, bat)
    per = {}
    for c in cplxs:
        s, b = (json.load(open(os.path.join(work, d, f"{c.name}.json")))
                for d in ("seq", "bat"))
        for k in ("hit_top1", "hit_top10"):
            assert s[k] == b[k], (c.name, k, s[k], b[k])
        per[c.name] = [s["poses"][0]["lrmsd"], b["poses"][0]["lrmsd"]]
    out["batched_eval"] = dict(sequential=seq, batched=bat,
                               top1_lrmsd_seq_bat=per)
    # (c) one parallel train step == the one-device loss.
    tcfg = PRESETS["train"]
    if train_grid:
        tcfg = tcfg.replace(grid_size=train_grid)
    train_set = [_complex(400 + i, n_lig, n_lig // 2) for i in range(4)]
    tcfg = fit_lig_grid(train_set, tcfg)
    trainer = Trainer(tcfg)
    state = trainer.init_state()
    batch = make_training_batch(jax.random.key(0), train_set, tcfg)
    loss1 = float(trainer.loss_fn(state.params, batch)[0])
    step = make_parallel_train_step(trainer, make_mesh(rot=2, batch=2))
    _, metrics = step(state, batch)
    loss4 = float(metrics["loss"])
    assert abs(loss4 - loss1) <= 1e-4 * max(1.0, abs(loss1)), (loss1,
                                                               loss4)
    out["parallel_train_step"] = dict(loss_1dev=loss1, loss_mesh=loss4)
    return out


def _run(name, fn, *a, **kw):
    t0 = time.perf_counter()
    try:
        res = fn(*a, **kw)
    except Exception:  # noqa: BLE001 — reported, then the script fails
        traceback.print_exc()
        print(f"phase {name}: FAILED", flush=True)
        return False
    print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) "
          f"{json.dumps(res)}", flush=True)
    return True


def main(argv):
    four = "--four" in argv
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    if four and len(jax.devices()) < 4:
        print(f"chip_smoke --four: needs 4 GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    from deeplocalproteindocking_tpu.utils.cache import (
        enable_compilation_cache)
    from deeplocalproteindocking_tpu.utils.device import (
        device_record, nvidia_smi_line)
    enable_compilation_cache()
    print(f"card: {nvidia_smi_line()}", flush=True)
    with tempfile.TemporaryDirectory() as work:
        if four:
            ok = [_run("four_gpu", phase_four, work)]
        else:
            ok = [_run("1_dock_cli", phase_dock_cli, work),
                  _run("2_full_sweep", phase_full_sweep),
                  _run("3_reference", phase_reference),
                  _run("4_train", phase_train, work)]
    if not all(ok):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
