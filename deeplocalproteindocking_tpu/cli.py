"""Command-line entry points (reference P10: train / dock / benchmark /
generate-dataset argparse scripts [U: DeepLocalProteinDocking top-level
*.py — mount empty, unverified]).

Usage: ``python -m deeplocalproteindocking_tpu.cli <command> ...``
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", default=None,
                   help="named preset from config.PRESETS")
    p.add_argument("--grid-size", type=int, default=None)
    p.add_argument("--resolution", type=float, default=None)
    p.add_argument("--num-rotations", type=int, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--local-cone-deg", type=float, default=None)
    p.add_argument("--mesh-rot", type=int, default=None)
    p.add_argument("--sweep-mode", default=None,
                   choices=["resplat", "resample"])
    p.add_argument("--fft-impl", default=None,
                   choices=["dft", "xla", "block"])
    p.add_argument("--fft-block", type=int, default=None,
                   help="translation-block edge for --fft-impl block "
                        "(must divide grid size)")
    p.add_argument("--coupling-rank", type=int, default=None,
                   help="SVD-truncate the learned channel coupling to "
                        "this rank before the sweep (rank 3 is the "
                        "licensed flagship default — DESIGN.md 'rank "
                        "licensing'; 0/unset = full rank)")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (SURVEY.md §5.2)")
    p.add_argument("--profile", default=None,
                   help="directory for a jax.profiler trace")


def _build_config(args):
    from deeplocalproteindocking_tpu.config import DockConfig, PRESETS
    cfg = PRESETS[args.preset] if args.preset else DockConfig()
    # A checkpoint carries the config it was trained with; use it as the
    # base so scoring semantics (resolution, sigma, grid, model width)
    # match the weights, then overlay explicit CLI flags.
    ckpt = getattr(args, "checkpoint", None)
    if ckpt:
        ckpt_cfg_path = os.path.join(ckpt, "config.json")
        if os.path.exists(ckpt_cfg_path):
            with open(ckpt_cfg_path) as f:
                cfg = DockConfig.from_json(f.read())
    overrides = {k: getattr(args, a) for k, a in [
        ("grid_size", "grid_size"), ("resolution", "resolution"),
        ("num_rotations", "num_rotations"), ("top_k", "top_k"),
        ("local_cone_deg", "local_cone_deg"), ("mesh_rot", "mesh_rot"),
        ("sweep_mode", "sweep_mode"), ("fft_impl", "fft_impl"),
        ("fft_block", "fft_block"),
    ] if getattr(args, a, None) is not None}
    cr = getattr(args, "coupling_rank", None)
    if cr is not None:
        overrides["coupling_rank"] = cr or None   # 0 -> full rank
    if getattr(args, "debug_nans", False):
        overrides["debug_nans"] = True
    if getattr(args, "global_frac", None) is not None:
        overrides["decoy_global_frac"] = args.global_frac
    if ckpt:
        # Geometry flags change scoring semantics relative to training.
        for geom in ("resolution", "grid_size"):
            if geom in overrides and overrides[geom] != getattr(cfg, geom):
                print(f"warning: --{geom.replace('_', '-')}="
                      f"{overrides[geom]} differs from the checkpoint's "
                      f"training value {getattr(cfg, geom)}; scores may "
                      f"not match training semantics", file=sys.stderr)
    cfg = cfg.replace(**overrides)
    if cfg.debug_nans:
        import jax
        jax.config.update("jax_debug_nans", True)
    return cfg


def _build_pipeline(cfg, checkpoint=None):
    from deeplocalproteindocking_tpu.pipeline import DockingPipeline
    from deeplocalproteindocking_tpu.parallel.mesh import make_mesh
    mesh = None
    if cfg.mesh_rot > 1 or cfg.mesh_batch > 1:
        mesh = make_mesh(rot=cfg.mesh_rot, batch=cfg.mesh_batch)
    pipe = DockingPipeline(config=cfg, mesh=mesh)
    if checkpoint:
        from deeplocalproteindocking_tpu.train.trainer import Trainer
        state = Trainer(cfg).restore(checkpoint)
        pipe.params = state.params
    return pipe


def cmd_dock(args):
    from deeplocalproteindocking_tpu.structure.mmcif import (
        parse_structure)
    from deeplocalproteindocking_tpu.structure.pdb import write_pdb
    from deeplocalproteindocking_tpu.utils.profiling import maybe_trace
    import dataclasses
    cfg = _build_config(args)
    pipe = _build_pipeline(cfg, args.checkpoint)

    def load(path, model, chain_sel):
        s = parse_structure(path, model=model).typed()
        return s.chains(list(chain_sel)) if chain_sel else s

    if args.ensemble:
        if args.rescore_top or args.refine_steps:
            raise SystemExit(
                "--ensemble is incompatible with --rescore-top/"
                "--refine-steps (rescoring is defined per model pair); "
                "dock a single model pair instead")
        from deeplocalproteindocking_tpu.structure.mmcif import (
            count_models)
        n_rec = count_models(args.receptor)
        n_lig = count_models(args.ligand)
        if args.max_models:
            n_rec = min(n_rec, args.max_models)
            n_lig = min(n_lig, args.max_models)
        recs = [load(args.receptor, m + 1, args.receptor_chains)
                for m in range(n_rec)]
        ligs = [load(args.ligand, m + 1, args.ligand_chains)
                for m in range(n_lig)]
        print(f"ensemble dock: {n_rec} receptor x {n_lig} ligand "
              f"models ({args.ensemble} pairing)")
        with maybe_trace(args.profile):
            poses, pairs = pipe.dock_ensemble(recs, ligs,
                                              pairing=args.ensemble)
        lig_models = [l.centered() for l in ligs]
        os.makedirs(args.out, exist_ok=True)
        for i in range(min(len(poses), args.num_out)):
            src = lig_models[int(pairs[i, 1])]
            s = dataclasses.replace(src)
            s.coords = poses.ligand_coords(src.coords, i).astype(
                np.float32)
            write_pdb(os.path.join(args.out, f"pose_{i:03d}.pdb"), s)
        table = [dict(rank=i, score=float(poses.scores[i]),
                      rot_idx=int(poses.rot_idx[i]),
                      shift=[int(v) for v in poses.shifts[i]],
                      receptor_model=int(pairs[i, 0]) + 1,
                      ligand_model=int(pairs[i, 1]) + 1)
                 for i in range(len(poses))]
        with open(os.path.join(args.out, "poses.json"), "w") as f:
            json.dump(table, f, indent=2)
        print(f"wrote {min(len(poses), args.num_out)} pose PDBs + "
              f"poses.json to {args.out}")
        return

    rec = load(args.receptor, args.receptor_model, args.receptor_chains)
    lig = load(args.ligand, args.ligand_model, args.ligand_chains)
    with maybe_trace(args.profile):
        poses = pipe.dock(rec, lig)
        if args.rescore_top:
            poses = pipe.rescore(rec, lig, poses, top=args.rescore_top)
        if args.refine_steps:
            poses = pipe.refine(rec, lig, poses,
                                steps=args.refine_steps)
    os.makedirs(args.out, exist_ok=True)
    lig_centered = lig.centered()
    for i in range(min(len(poses), args.num_out)):
        s = dataclasses.replace(lig_centered)
        s.coords = poses.ligand_coords(lig_centered.coords, i).astype(
            np.float32)
        write_pdb(os.path.join(args.out, f"pose_{i:03d}.pdb"), s)
    table = [dict(rank=i, score=float(poses.scores[i]),
                  rot_idx=int(poses.rot_idx[i]),
                  shift=[int(v) for v in poses.shifts[i]])
             for i in range(len(poses))]
    with open(os.path.join(args.out, "poses.json"), "w") as f:
        json.dump(table, f, indent=2)
    print(f"wrote {min(len(poses), args.num_out)} pose PDBs + poses.json "
          f"to {args.out}")


def cmd_generate_dataset(args):
    from deeplocalproteindocking_tpu.data.benchmark import (
        synthetic_complex)
    from deeplocalproteindocking_tpu.structure.pdb import write_pdb
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.num_complexes):
        c = synthetic_complex(seed=args.seed + i,
                              backbone=args.backbone,
                              unbound_rmsd=args.unbound_rmsd)
        write_pdb(os.path.join(args.out, f"{c.name}_r_u.pdb"), c.receptor)
        write_pdb(os.path.join(args.out, f"{c.name}_l_u.pdb"), c.ligand)
        if args.decoys:
            # Offline decoy pose sets with LRMSD labels — the
            # reference's generate_dataset stage serializes these
            # (SURVEY.md §3.3); training here can also regenerate them
            # on the fly, so the file is for interchange/inspection.
            import jax
            import jax.numpy as jnp
            from deeplocalproteindocking_tpu.train.data_gen import (
                native_voxel_shift)
            from deeplocalproteindocking_tpu.train.decoys import (
                generate_decoys)
            lig_c = c.ligand.centered().typed()
            ds = generate_decoys(
                jax.random.key(args.seed + i),
                jnp.asarray(lig_c.coords),
                jnp.ones(len(lig_c)),
                jnp.asarray(native_voxel_shift(c, 1.25)),
                n=args.decoys, resolution=1.25,
                max_angle=np.deg2rad(50.0), max_shift=8.0)
            np.savez(os.path.join(args.out, f"{c.name}_decoys.npz"),
                     rotations=np.asarray(ds.rotations),
                     shifts=np.asarray(ds.shifts),
                     lrmsd=np.asarray(ds.lrmsd))
    print(f"wrote {args.num_complexes} synthetic complexes to {args.out}"
          + (f" (+{args.decoys}-pose decoy sets)" if args.decoys
             else ""))


def cmd_screen(args):
    from deeplocalproteindocking_tpu.serving import DockingService
    from deeplocalproteindocking_tpu.structure.mmcif import (
        parse_structure)
    cfg = _build_config(args)
    pipe = _build_pipeline(cfg, args.checkpoint)
    svc = DockingService(cfg, params=pipe.params, mesh=pipe.mesh)
    rec = parse_structure(args.receptor).typed()
    if os.path.isdir(args.ligands):
        paths = sorted(
            os.path.join(args.ligands, f)
            for f in os.listdir(args.ligands)
            if f.endswith((".pdb", ".cif", ".mmcif")))
    else:
        paths = args.ligands.split(",")
    os.makedirs(args.out, exist_ok=True)
    ranking = []
    for path in paths:
        lig = parse_structure(path).typed()
        poses = svc.dock(rec, lig)
        if args.rescore_top:
            poses = svc.rescore(rec, lig, poses, top=args.rescore_top)
        name = os.path.splitext(os.path.basename(path))[0]
        ranking.append(dict(
            ligand=name, best_score=float(poses.scores[0]),
            poses=[dict(rank=i, score=float(poses.scores[i]),
                        shift=[int(v) for v in poses.shifts[i]])
                   for i in range(min(len(poses), args.num_out))]))
    ranking.sort(key=lambda r: -r["best_score"])
    with open(os.path.join(args.out, "screen.json"), "w") as f:
        json.dump(dict(receptor=args.receptor,
                       cache=svc.stats, ranking=ranking), f, indent=2)
    print(f"screened {len(paths)} ligands "
          f"(receptor prepared {svc.stats['misses']}x, "
          f"served {svc.stats['hits']}x from cache); "
          f"ranking -> {args.out}/screen.json")


def _load_complexes(args):
    from deeplocalproteindocking_tpu.data.benchmark import (
        list_benchmark, load_complex, synthetic_complex)
    if args.data_dir:
        return [load_complex(args.data_dir, c)
                for c in list_benchmark(args.data_dir)]
    return [synthetic_complex(seed=i) for i in range(args.synthetic)]


def cmd_evaluate(args):
    from deeplocalproteindocking_tpu.evaluation import (
        run_benchmark, run_benchmark_batched)
    from deeplocalproteindocking_tpu.utils.profiling import maybe_trace
    cfg = _build_config(args)
    pipe = _build_pipeline(cfg, args.checkpoint)
    complexes = _load_complexes(args)
    with maybe_trace(args.profile):
        if args.batch_size > 1:
            summary = run_benchmark_batched(
                pipe, complexes, args.out,
                group_size=args.batch_size,
                refine_steps=args.refine_steps,
                rescore_top=getattr(args, "rescore_top", 0))
        else:
            summary = run_benchmark(
                pipe, complexes, args.out,
                refine_steps=args.refine_steps,
                rescore_top=getattr(args, "rescore_top", 0))
    print(json.dumps(summary, indent=2))


def cmd_train(args):
    from deeplocalproteindocking_tpu.train.data_gen import (
        fit_lig_grid, make_training_batch)
    from deeplocalproteindocking_tpu.train.trainer import Trainer
    from deeplocalproteindocking_tpu.utils.logging import MetricsLogger
    import jax
    cfg = _build_config(args)
    complexes = _load_complexes(args)
    cfg = fit_lig_grid(complexes, cfg)   # auto-size for big ligands
    trainer = Trainer(cfg)
    if args.resume and os.path.isdir(args.ckpt_dir) and any(
            d.startswith("step_") for d in os.listdir(args.ckpt_dir)):
        state = trainer.restore(args.ckpt_dir)
        print(f"resumed from step {int(state.step)}")
    else:
        state = trainer.init_state()
    step_fn = trainer.train_step
    if cfg.mesh_rot > 1 or cfg.mesh_batch > 1:
        from deeplocalproteindocking_tpu.parallel import (
            make_mesh, make_parallel_train_step)
        mesh = make_mesh(rot=cfg.mesh_rot, batch=cfg.mesh_batch)
        step_fn = make_parallel_train_step(trainer, mesh)
        print(f"multi-chip training on mesh (rot={cfg.mesh_rot}, "
              f"batch={cfg.mesh_batch})")
    logger = MetricsLogger(os.path.join(args.ckpt_dir, "train.jsonl"))
    key = state.key
    mined = None
    for step in range(int(state.step), args.steps):
        if args.mine_every and step % args.mine_every == 0:
            from deeplocalproteindocking_tpu.train.mining import (
                mine_hard_negatives)
            mined = mine_hard_negatives(
                trainer.model, state.params, cfg, complexes,
                n_rotations=args.mine_rotations)
            logger.log("mined_hard_negatives", step=step,
                       complexes=len(mined))
        key, k_batch = jax.random.split(key)
        batch = make_training_batch(k_batch, complexes, cfg, mined=mined)
        state, metrics = step_fn(state, batch)
        logger.log("train_step", step=step, **metrics)
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            trainer.save(args.ckpt_dir, state)
    print(f"trained to step {int(state.step)}; checkpoints in "
          f"{args.ckpt_dir}")


def _backend_report():
    """Backend identity + device count, queried in this process."""
    import jax
    d = jax.devices()
    return dict(backend=jax.default_backend(), n_devices=len(d),
                device0=str(d[0]), device_kind=d[0].device_kind)


def cmd_info(args):
    from deeplocalproteindocking_tpu.config import PRESETS
    b = _backend_report()
    print(f"devices: {b['n_devices']} x {b['device_kind']} "
          f"({b['backend']})")
    print("presets:")
    for name, cfg in PRESETS.items():
        print(f"  {name}: grid={cfg.grid_size} rot={cfg.num_rotations} "
              f"topk={cfg.top_k} mesh=({cfg.mesh_rot},{cfg.mesh_batch})")


def cmd_doctor(args):
    """Operational diagnostics: backend, native libs, compile cache,
    checkpoint rank license.  Exits non-zero when the backend or the
    checkpoint check fails."""
    report = {}
    ok = True

    try:
        b = _backend_report()
        report["backend"] = dict(ok=True, **b)
        print(f"[ok]   backend: {b['backend']} ({b['n_devices']} "
              f"device(s), {b['device_kind']})")
    except RuntimeError as e:
        ok = False
        report["backend"] = dict(ok=False, error=str(e))
        print(f"[FAIL] backend: {e}")

    # Native fast paths (optional — pure-Python fallbacks exist).
    for mod, syms in [("pdb_native", ["pdb_parse_v2"]),
                      ("cif_native", ["cif_tokenize_v1",
                                      "cif_atom_site_v1"])]:
        try:
            import importlib
            m = importlib.import_module(
                f"deeplocalproteindocking_tpu.native.{mod}")
            missing = [s for s in syms if not hasattr(m._lib, s)]
            if missing:
                print(f"[warn] native {mod}: loaded but missing "
                      f"{missing} (pure-Python fallback active)")
                report[mod] = dict(ok=False, missing=missing)
            else:
                print(f"[ok]   native {mod}: {', '.join(syms)}")
                report[mod] = dict(ok=True)
        except Exception as e:  # noqa: BLE001 — optional fast path
            print(f"[warn] native {mod}: unavailable "
                  f"({type(e).__name__}: {e}) — pure-Python fallback")
            report[mod] = dict(ok=False, error=str(e))

    from deeplocalproteindocking_tpu.utils.cache import cache_dir
    cd = cache_dir()
    n_entries = sum(len(fs) for _, _, fs in os.walk(cd)) \
        if os.path.isdir(cd) else 0
    print(f"[ok]   compile cache: {cd} ({n_entries} entries)")
    report["cache"] = dict(path=cd, entries=n_entries)

    # Checkpoint rank license (DESIGN.md round-4 criterion).
    if args.checkpoint:
        from deeplocalproteindocking_tpu.config import DockConfig
        from deeplocalproteindocking_tpu.pipeline import (
            coupling_deviation_capture, min_licensed_rank)
        from deeplocalproteindocking_tpu.train import Trainer
        with open(os.path.join(args.checkpoint, "config.json")) as f:
            tcfg = DockConfig.from_json(f.read())
        state = Trainer(tcfg).restore(args.checkpoint)
        A = np.asarray(state.params["coupling"])
        lic = min_licensed_rank(A, shape_prior=tcfg.shape_prior)
        kept, dev = coupling_deviation_capture(
            A, lic, shape_prior=tcfg.shape_prior)
        print(f"[ok]   checkpoint coupling {A.shape}: licensed rank >= "
              f"{lic} (keeps {kept:.0%} of the learned deviation "
              f"||A-prior||={dev:.4f})")
        report["license"] = dict(shape=list(A.shape), licensed_rank=lic,
                                 kept=kept, deviation=dev)

    # Machine-readable final line (same one-JSON-line convention as
    # bench.py) so doctor is scriptable.
    print(json.dumps(dict(doctor_ok=ok, **report)))
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deeplocalproteindocking_tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("dock", help="dock one receptor/ligand pair")
    p.add_argument("--receptor", required=True)
    p.add_argument("--ligand", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--num-out", type=int, default=10)
    p.add_argument("--receptor-model", type=int, default=1,
                   help="NMR model of the receptor file to dock "
                        "(1-based; PDB MODEL records or mmCIF "
                        "pdbx_PDB_model_num)")
    p.add_argument("--ligand-model", type=int, default=1,
                   help="NMR model of the ligand file to dock")
    p.add_argument("--ensemble", choices=["product", "zip"],
                   default=None,
                   help="dock ALL NMR models of both files and merge "
                        "the ranked poses (product: every pair; zip: "
                        "model i vs model i); overrides "
                        "--receptor-model/--ligand-model")
    p.add_argument("--max-models", type=int, default=0,
                   help="with --ensemble, cap the models taken from "
                        "each file (0 = all)")
    p.add_argument("--receptor-chains", default="",
                   help="chain letters to keep, e.g. 'AB'")
    p.add_argument("--ligand-chains", default="")
    p.add_argument("--refine-steps", type=int, default=0,
                   help="continuous pose refinement iterations")
    p.add_argument("--rescore-top", type=int, default=0,
                   help="hierarchical rescoring: dense local cone "
                        "sweep around each of the top-N cluster heads")
    _add_config_args(p)
    p.set_defaults(fn=cmd_dock)

    p = sub.add_parser("generate-dataset",
                       help="write synthetic benchmark complexes")
    p.add_argument("--out", required=True)
    p.add_argument("--num-complexes", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backbone", action="store_true",
                   help="polymer covalent geometry (data/polymer.py; "
                        "the round-3 flagship protocol)")
    p.add_argument("--unbound-rmsd", type=float, default=0.0,
                   help="deform receptor+ligand in place by this "
                        "per-atom RMSD (DB-style unbound protocol)")
    p.add_argument("--decoys", type=int, default=0,
                   help="also write an N-pose labeled decoy set per "
                        "complex (<name>_decoys.npz: rotations, voxel "
                        "shifts, LRMSD labels — the reference's "
                        "offline dataset-generation stage)")
    p.set_defaults(fn=cmd_generate_dataset)

    p = sub.add_parser("evaluate", help="benchmark sweep + hit-rate table")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", type=int, default=4)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--refine-steps", type=int, default=0)
    p.add_argument("--rescore-top", type=int, default=0,
                   help="hierarchical rescoring of the top-N cluster "
                        "heads before grading (sequential and batched "
                        "modes)")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1: dock complex groups as one program "
                        "(throughput mode, configs[4])")
    _add_config_args(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("train", help="train the representation model")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mine-every", type=int, default=0,
                   help=">0: refresh FFT-mined hard negatives every N "
                        "steps (train/mining.py)")
    p.add_argument("--mine-rotations", type=int, default=256)
    p.add_argument("--global-frac", type=float, default=None,
                   help="fraction of decoys sampled globally "
                        "(config.decoy_global_frac)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "screen",
        help="dock ONE receptor against MANY ligands (serving path: "
             "the receptor representation+spectrum is computed once "
             "and cached — serving.DockingService)")
    p.add_argument("--receptor", required=True)
    p.add_argument("--ligands", required=True,
                   help="directory of ligand .pdb/.cif files, or a "
                        "comma-separated file list")
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--num-out", type=int, default=5)
    p.add_argument("--rescore-top", type=int, default=0)
    _add_config_args(p)
    p.set_defaults(fn=cmd_screen)

    p = sub.add_parser("info", help="devices and presets")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "doctor",
        help="operational diagnostics: backend, native libs, compile "
             "cache, checkpoint rank license")
    p.add_argument("--checkpoint", default=None,
                   help="also report this checkpoint's coupling-rank "
                        "license (dir containing config.json)")
    p.set_defaults(fn=cmd_doctor)

    args = ap.parse_args(argv)
    from deeplocalproteindocking_tpu.utils.cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
