"""README results matrix: learned vs shape, global + local protocols.

Held-out synthetic complexes (seeds >= 100, disjoint from every
training seed).  Global protocol: full super-Fibonacci SO(3) sweep,
unrestricted translations.  Local protocol: 50-degree cone around the
native orientation, +-8 A translations (the reference's local-docking
evaluation).

Usage: python tools/eval_matrix.py [ckpt_dir] [out_json]
Env: EM_NROT (global rotations, default 1536), EM_GRID (default 64),
     EM_COMPLEXES (default 8), EM_MODES ("global,local"), EM_WIDEN,
     EM_SEED0, EM_UNBOUND (deformation RMSD), EM_DTYPE,
     EM_BACKBONE (polymer-geometry fixtures, round-3 protocol),
     EM_RANK (coupling_rank truncation for the learned rows),
     EM_RESCORE (top-N hierarchical rescoring in global mode).
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from deeplocalproteindocking_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.data import synthetic_complex
from deeplocalproteindocking_tpu.evaluation import grade_poses
from deeplocalproteindocking_tpu.pipeline import DockingPipeline
from deeplocalproteindocking_tpu.train import Trainer


def heldout_complexes(n, widen=False, seed0=100, unbound=0.0,
                      backbone=False):
    """Held-out report complexes (seeds 100+, disjoint from training
    seeds 200+ and validation seeds 50+).  ``widen`` draws sizes from
    the same 9x5 (receptor 12..20, ligand 6..10 residue) grid as
    training/validation — the harder, size-diverse benchmark.
    ``seed0`` selects an alternative disjoint band (e.g. a large
    internal dev-test set) without touching the report seeds."""
    if widen:
        return [synthetic_complex(seed=seed0 + s,
                                  n_res_rec=12 + s % 9,
                                  n_res_lig=6 + (s // 9) % 5,
                                  unbound_rmsd=unbound,
                                  backbone=backbone)
                for s in range(n)]
    return [synthetic_complex(seed=seed0 + s, n_res_rec=14 + s % 5,
                              n_res_lig=7 + s % 3, unbound_rmsd=unbound,
                              backbone=backbone) for s in range(n)]


def eval_row(dock_fn, complexes, label, partial=None, on_progress=None):
    """Grade ``dock_fn(c)`` poses over ``complexes``, resumably.

    ``partial`` is a list of already-graded row dicts (matched by
    complex name) from an interrupted run; ``on_progress(rows)`` is
    called after every complex so the caller can checkpoint.  Per-
    complex resume matters: a device worker fault 40 complexes into a
    48-complex row must not restart the row (round 4: three straight
    rerank-row attempts died mid-row and the whole matrix stalled).
    """
    rows = list(partial or [])
    done = {r["name"] for r in rows}
    for c in complexes:
        if c.name in done:
            continue
        graded = grade_poses(c, dock_fn(c))
        h1 = bool(graded and graded[0]["capri"] != "incorrect")
        h10 = any(g["capri"] != "incorrect" for g in graded[:10])
        rows.append(dict(name=c.name, hit_top1=h1, hit_top10=h10,
                         best_lrmsd=min((g["lrmsd"] for g in graded),
                                        default=None)))
        print(f"  {label} {c.name}: top1={h1} top10={h10}", flush=True)
        if on_progress is not None:
            on_progress(rows)
    by_name = {r["name"]: r for r in rows}
    rows = [by_name[c.name] for c in complexes]
    n = len(complexes)
    return dict(top1=sum(r["hit_top1"] for r in rows) / n,
                top10=sum(r["hit_top10"] for r in rows) / n,
                complexes=rows)


def fingerprints_match(row_fp, fingerprint, key):
    """Protocol equality for row ``key``, ignoring knobs the row does
    not depend on.

    ``agg`` only affects the rerank row (whose key already encodes a
    non-default aggregator); comparing it for every row would make a
    later ``EM_AGG=topmean`` run — whose stated purpose is ADDING a
    second rerank row to an existing matrix — silently discard and
    recompute all the agg-independent rows it shares the file with.
    """
    if not key.startswith("learned_rerank"):
        def strip(fp):
            return {k: v for k, v in fp.items() if k != "agg"}
        return strip(row_fp) == strip(fingerprint)
    return row_fp == fingerprint


def completed_row_reusable(results, key, fingerprint):
    """Whether ``results[key]`` (a finished row) may be reused under
    ``fingerprint``; discards the row from ``results`` when not.

    Completed rows are fingerprint-guarded like partials (round-4
    ADVICE): re-running with different EM_* env against the same file
    must not silently mix two protocols in one matrix.  Legacy rows
    (written before fingerprints existed) are kept with a warning —
    discarding them would force a full recompute of every historical
    matrix on first touch.
    """
    if key not in results:
        return False
    row_fp = (results[key].get("fingerprint")
              if isinstance(results[key], dict) else None)
    if row_fp is None:
        print(f"keeping legacy row {key} (no fingerprint recorded); "
              f"delete it to recompute under the current protocol",
              flush=True)
        return True
    if fingerprints_match(row_fp, fingerprint, key):
        return True
    print(f"discarding completed row {key}: protocol changed "
          f"({row_fp} -> {fingerprint})", flush=True)
    del results[key]
    return False


def check_seed_disjointness(ckpt, seed0, n_cplx):
    """Refuse held-out bands that overlap the checkpoint's training or
    validation seeds.

    ``synthetic_complex`` derives the whole structure from
    ``np.random.default_rng(seed)``, so two complexes with the same
    seed share their random stream even at different residue counts —
    seed overlap is structural leakage, not a coincidence of labels.
    v9p trained on seeds 200..1223 (TF_SEEDS=1024), which silently
    swallowed the planned "disjoint" second band at 300-347; this
    guard makes that class of protocol bug impossible to repeat.
    Override (e.g. for an explicit train-set diagnostic) with
    EM_ALLOW_TRAIN_OVERLAP=1.
    """
    meta = None
    for d in (ckpt, os.path.dirname(ckpt.rstrip("/"))):
        p = os.path.join(d, "TRAINING.json")
        if d and os.path.exists(p):
            with open(p) as f:
                meta = json.load(f)
            break
    if meta is None:
        return
    held = set(range(seed0, seed0 + n_cplx))
    bands = {
        "train": range(meta.get("train_seed0", 200),
                       meta.get("train_seed0", 200)
                       + int(meta.get("n_train", 0))),
        "val": range(meta.get("val_seed0", 50),
                     meta.get("val_seed0", 50)
                     + int(meta.get("n_val", 0))),
    }
    for name, band in bands.items():
        hit = sorted(held & set(band))
        if not hit:
            continue
        msg = (f"held-out band {seed0}..{seed0 + n_cplx - 1} overlaps "
               f"the checkpoint's {name} seeds "
               f"{band.start}..{band.stop - 1} (e.g. {hit[:4]}): "
               f"this would evaluate on {name} complexes. Pick a "
               f"disjoint EM_SEED0 or set EM_ALLOW_TRAIN_OVERLAP=1 "
               f"for an explicit in-{name} diagnostic.")
        if os.environ.get("EM_ALLOW_TRAIN_OVERLAP", "0") == "1":
            print("WARNING (overridden):", msg, flush=True)
        else:
            raise SystemExit("eval_matrix: " + msg)


def mode_dock_fn(pipe, mode, cfg, rescore_top=0):
    from deeplocalproteindocking_tpu.train.data_gen import (
        native_voxel_shift)

    def dock_fn(c):
        kw = {}
        if mode == "local":
            kw["rotations"] = pipe.rotation_set(None)
            kw["translation_center"] = native_voxel_shift(
                c, cfg.resolution)
            kw["max_shift"] = cfg.decoy_max_shift
        poses = pipe.dock_complex(c, **kw)
        if rescore_top and mode == "global":
            poses = pipe.rescore(c.receptor, c.ligand, poses,
                                 top=rescore_top)
        return poses

    return dock_fn


def main():
    ckpt = sys.argv[1] if len(sys.argv) > 1 else "pretrained/synthetic-v4"
    out_path = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ckpt, "eval_matrix.json")
    n_rot = int(os.environ.get("EM_NROT", 1536))
    grid = int(os.environ.get("EM_GRID", 64))
    n_cplx = int(os.environ.get("EM_COMPLEXES", 8))
    modes = os.environ.get("EM_MODES", "global,local").split(",")

    widen = os.environ.get("EM_WIDEN", "0") == "1"
    rescore_top = int(os.environ.get("EM_RESCORE", 0))
    seed0 = int(os.environ.get("EM_SEED0", 100))
    unbound = float(os.environ.get("EM_UNBOUND", 0.0))
    backbone = os.environ.get("EM_BACKBONE", "0") == "1"
    check_seed_disjointness(ckpt, seed0, n_cplx)
    complexes = heldout_complexes(n_cplx, widen=widen, seed0=seed0,
                                  unbound=unbound, backbone=backbone)
    # Row-level resume: a device worker fault mid-matrix must not lose
    # completed rows (measured round 4: a 48-complex rerank row died
    # 2/3 of the way through the matrix and the whole run was lost).
    # Fingerprint of every env knob that changes what a row MEANS: a
    # partial row resumed under a different protocol would silently mix
    # two configurations inside one row (exactly the licensing
    # comparisons this matrix exists for), so partials carry this and
    # are discarded on mismatch.
    fingerprint = dict(n_rot=n_rot, grid=grid, n_cplx=n_cplx,
                      widen=widen, seed0=seed0, unbound=unbound,
                      backbone=backbone, rescore=rescore_top,
                      dtype=os.environ.get("EM_DTYPE", "bfloat16"),
                      rank=int(os.environ.get("EM_RANK", 0)),
                      agg=os.environ.get("EM_AGG", "max"))
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
        done = [k for k in results
                if k != "protocol" and not k.startswith("_partial_")]
        if done:
            print(f"resuming: rows {done} already computed", flush=True)

    def checkpoint_row():
        with open(out_path + ".tmp", "w") as f:
            json.dump(results, f, indent=2)
        os.replace(out_path + ".tmp", out_path)

    def run_row(key, dock_fn, complexes):
        """Compute one matrix row with per-complex checkpoint/resume."""
        if completed_row_reusable(results, key, fingerprint):
            return
        pkey = "_partial_" + key
        partial = results.get(pkey)
        if isinstance(partial, list):      # pre-fingerprint format
            partial = dict(fingerprint=None, rows=partial)
        if partial is not None:
            if not (partial.get("fingerprint") is not None
                    and fingerprints_match(partial["fingerprint"],
                                           fingerprint, key)):
                print(f"discarding partial {key}: protocol changed "
                      f"({partial.get('fingerprint')} -> {fingerprint})",
                      flush=True)
                partial = None
            else:
                partial = partial.get("rows")

        def on_progress(rows):
            results[pkey] = dict(fingerprint=fingerprint, rows=rows)
            checkpoint_row()

        row = eval_row(dock_fn, complexes, key,
                       partial=partial, on_progress=on_progress)
        row["fingerprint"] = fingerprint
        # Provenance, not protocol: bf16==fp32 licensing showed hit
        # decisions are numerics-robust, so platform is recorded for
        # honesty but deliberately kept out of the fingerprint (a row
        # started on CPU may be finished on the GPU).
        import jax
        row["platform"] = jax.default_backend()
        results[key] = row
        results.pop(pkey, None)
        checkpoint_row()

    for mode in modes:
        local = mode == "local"
        base = dict(grid_size=grid, resolution=1.25,
                    num_rotations=64 if local else n_rot,
                    local_cone_deg=50.0 if local else None,
                    rotation_chunk=64, top_k=64, nms_rmsd=5.0,
                    decoy_max_shift=8.0)

        # Shape-complementarity baseline (params=None).
        shape_cfg = DockConfig(rep_features=(8,), **base)
        shape_pipe = DockingPipeline(config=shape_cfg)
        run_row(f"shape_{mode}",
                mode_dock_fn(shape_pipe, mode, shape_cfg,
                             rescore_top=rescore_top), complexes)
        print(mode, "shape:", results[f"shape_{mode}"]["top1"],
              results[f"shape_{mode}"]["top10"], flush=True)

        # Learned model from the checkpoint (its own trained config,
        # geometry overridden to the eval protocol).
        with open(os.path.join(ckpt, "config.json")) as f:
            tcfg = DockConfig.from_json(f.read())
        dt = os.environ.get("EM_DTYPE", "bfloat16")
        rank = int(os.environ.get("EM_RANK", 0)) or None
        lcfg = tcfg.replace(compute_dtype=dt, dft_dtype=dt,
                            lig_grid_size=None, coupling_rank=rank,
                            **base)
        trainer = Trainer(tcfg)
        state = trainer.restore(ckpt)
        lpipe = DockingPipeline(config=lcfg)
        lpipe.params = state.params
        run_row(f"learned_{mode}",
                mode_dock_fn(lpipe, mode, lcfg,
                             rescore_top=rescore_top), complexes)
        print(mode, "learned:", results[f"learned_{mode}"]["top1"],
              results[f"learned_{mode}"]["top10"], flush=True)

        # Two-stage (the reference's own architecture: global candidates
        # from the cheap scorer, learned model ranks them): shape sweep
        # -> learned dense-cone rescore of the top heads.
        if os.environ.get("EM_RERANK", "0") == "1" and mode == "global":
            agg = os.environ.get("EM_AGG", "max")

            def rerank_fn(c):
                poses = shape_pipe.dock_complex(c)
                return lpipe.rescore(c.receptor, c.ligand, poses,
                                     top=16, aggregate=agg)

            # Aggregator is part of the row identity (round-4 VERDICT
            # weak #8): max vs topmean rows must not collide under one
            # key.  The default aggregator keeps the historical key so
            # existing matrices resume cleanly.
            rkey = ("learned_rerank_global" if agg == "max"
                    else f"learned_rerank_global_{agg}")
            run_row(rkey, rerank_fn, complexes)
            print(f"global learned_rerank[{agg}]:",
                  results[rkey]["top1"],
                  results[rkey]["top10"],
                  flush=True)

    results["protocol"] = dict(n_rotations=n_rot, grid=grid,
                               n_complexes=n_cplx, size_diverse=widen,
                               unbound_rmsd=unbound, backbone=backbone,
                               heldout_seeds=[seed0 + s
                                              for s in range(n_cplx)])
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: (dict(top1=v["top1"], top10=v["top10"])
                          if isinstance(v, dict) and "top1" in v else v)
                      for k, v in results.items()}, indent=2))


if __name__ == "__main__":
    main()
