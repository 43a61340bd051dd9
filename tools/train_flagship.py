"""Train the flagship hybrid model (pretrained/synthetic-v4).

Curriculum for GLOBAL-docking wins (round-1 VERDICT next-round #3):

* hybrid shape-prior model (untrained == shape complementarity,
  bias-free CNN — tests/test_hybrid.py) so the baseline is the
  optimization's zero point;
* local + GLOBAL decoys + FFT-mined hard negatives;
* AdamW weight decay + VALIDATION-SELECTED checkpoint: every
  ``val_every`` steps the current model runs a small global sweep on
  val complexes (seeds 50+, disjoint from train 0..N and report
  100+); the checkpoint with the best val global hit-rate wins.

Usage: python tools/train_flagship.py [steps] [ckpt_dir]
Env: TF_GRID, TF_NROT_MINE, TF_MINE_EVERY, TF_SEEDS, TF_VAL_EVERY,
TF_VAL_NROT, TF_VAL_COMPLEXES, TF_MINE_CHUNK, TF_SEED0,
TF_UNBOUND (deformation RMSD, unbound protocol), TF_EMA (decay,
0 = raw params), TF_BACKBONE (polymer-geometry fixtures, round 3),
TF_LR, TF_GLOBAL_FRAC, TF_NEAR_NATIVE, TF_MARGIN (recipe knobs).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from deeplocalproteindocking_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.data import synthetic_complex
from deeplocalproteindocking_tpu.evaluation import grade_poses
from deeplocalproteindocking_tpu.pipeline import DockingPipeline
from deeplocalproteindocking_tpu.train import Trainer
from deeplocalproteindocking_tpu.train.data_gen import (
    fit_lig_grid, make_training_batch)
from deeplocalproteindocking_tpu.train.mining import (
    load_mined, merge_mined, mine_hard_negatives, save_mined)
from deeplocalproteindocking_tpu.utils.logging import MetricsLogger


def make_complexes(seed0, n, widen=False, unbound=0.0,
                   backbone=False):
    """Synthetic complexes; ``widen=True`` varies sizes over a 9x5 grid
    (receptors 12..20, ligands 6..10 residues) — the round-2 diagnostic
    showed 48 complexes x 15 size combos improve TRAIN-global top-1
    (0.438 -> 0.562) without transferring to val: a data-diversity gap,
    not an objective failure.  ``unbound`` > 0 switches to the UNBOUND
    protocol (smooth conformational deformation of that RMSD, see
    data/benchmark.py) — on bound carved complexes shape
    complementarity is an oracle by construction, so that's where a
    learned representation can actually win."""
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


def val_global_hits(params, cfg, complexes, n_rot=256):
    """Global-sweep hit rates of the current params on val complexes."""
    vcfg = cfg.replace(num_rotations=n_rot, top_k=32,
                       local_cone_deg=None, lig_grid_size=None)
    pipe = DockingPipeline(config=vcfg)
    pipe.params = params
    h1 = h10 = 0
    best = []
    for c in complexes:
        poses = pipe.dock_complex(c)
        graded = grade_poses(c, poses)
        h1 += bool(graded and graded[0]["capri"] != "incorrect")
        h10 += any(g["capri"] != "incorrect" for g in graded[:10])
        best.append(min((g["lrmsd"] for g in graded), default=99.0))
    n = len(complexes)
    return h1 / n, h10 / n, float(np.mean(best))


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1500
    ckpt_dir = sys.argv[2] if len(sys.argv) > 2 else "pretrained/synthetic-v4"
    grid = int(os.environ.get("TF_GRID", 64))
    mine_every = int(os.environ.get("TF_MINE_EVERY", 50))
    mine_rots = int(os.environ.get("TF_NROT_MINE", 192))
    n_train = int(os.environ.get("TF_SEEDS", 192))
    seed0 = int(os.environ.get("TF_SEED0", 200))  # disjoint from val
                                                  # (50..) and held-out
                                                  # report seeds (100..)
    mine_chunk = int(os.environ.get("TF_MINE_CHUNK", 48))
    val_every = int(os.environ.get("TF_VAL_EVERY", 100))
    val_nrot = int(os.environ.get("TF_VAL_NROT", 256))
    n_val = int(os.environ.get("TF_VAL_COMPLEXES", 16))
    unbound = float(os.environ.get("TF_UNBOUND", 0.0))
    # EMA of params for validation/selection: the raw trajectory's val
    # top-1 swings +-0.25 between adjacent evals (v4 run: 0.69 -> 0.13
    # -> 0.50 across steps 600-800), so selecting a raw checkpoint
    # rides measurement+parameter noise; the averaged weights are the
    # stable estimate.  0 disables.
    ema_decay = float(os.environ.get("TF_EMA", 0.999))
    backbone = os.environ.get("TF_BACKBONE", "0") == "1"
    lr = float(os.environ.get("TF_LR", 3e-4))
    global_frac = float(os.environ.get("TF_GLOBAL_FRAC", 0.35))
    near_native = float(os.environ.get("TF_NEAR_NATIVE", 4.0))
    hinge = float(os.environ.get("TF_MARGIN", 20.0))
    # CNN stack widths (round 4: v9p's train ranking accuracy
    # plateaued at 0.652 — underfit — so capacity is a recipe knob).
    features = tuple(int(x) for x in
                     os.environ.get("TF_FEATURES", "32,14").split(","))

    cfg = DockConfig(
        grid_size=grid, resolution=1.25, rep_features=features,
        shape_prior=True,   # learned ++ 2 prior channels (default
                            # 14+2=16 correlation channels; eval
                            # absorbs wider stacks via the licensed
                            # rank-r coupling fold)
        num_decoys=24, batch_complexes=2, learning_rate=lr,
        lr_decay_steps=steps, weight_decay=1e-4,
        near_native_rmsd=near_native, hinge_margin=hinge,
        decoy_max_angle_deg=50.0, decoy_max_shift=8.0,
        decoy_global_frac=global_frac, mined_frac=1 / 3,
        rotation_chunk=16, augment_rotations=True)

    complexes = make_complexes(seed0, n_train, widen=True,
                               unbound=unbound, backbone=backbone)
    val_seed0 = int(os.environ.get("TF_VAL_SEED0", 50))
    val_cplx = make_complexes(val_seed0, n_val, widen=True,
                              unbound=unbound, backbone=backbone)
    cfg = fit_lig_grid(complexes, cfg)
    print(f"config: grid={cfg.grid_size} lig_grid={cfg.lig_grid_size} "
          f"decoys={cfg.num_decoys} global_frac={cfg.decoy_global_frac} "
          f"train={n_train} wd={cfg.weight_decay}")

    trainer = Trainer(cfg)
    logger = MetricsLogger(os.path.join(ckpt_dir, "train.jsonl"))
    best_dir = os.path.join(ckpt_dir, "best")
    best_json = os.path.join(ckpt_dir, "best.json")

    ema_dir = os.path.join(ckpt_dir, "ema")
    mined_npz = os.path.join(ckpt_dir, "mined.npz")
    resumed = False
    try:  # resume an interrupted run from its latest checkpoint
        cfg_path = os.path.join(ckpt_dir, "config.json")
        if os.path.exists(cfg_path):
            # The optimizer pytree depends on the config (e.g. a cosine
            # schedule keyed to the original total steps), so restore
            # with the run's SAVED config, not this invocation's.
            with open(cfg_path) as f:
                cfg = DockConfig.from_json(f.read())
            trainer = Trainer(cfg)
        state = trainer.restore(ckpt_dir)
        resumed = True
    except (FileNotFoundError, OSError):
        state = trainer.init_state()
        # Baseline = untrained hybrid == shape complementarity: the val
        # bar every later checkpoint must clear.
        v1, v10, vb = val_global_hits(state.params, cfg, val_cplx, n_rot=val_nrot)
        best = dict(top1=v1, top10=v10, lrmsd=vb, step=0)
        print(f"step 0 (== shape baseline): val global top1={v1:.3f} "
              f"top10={v10:.3f} best-lrmsd={vb:.2f}", flush=True)
        trainer.save(ckpt_dir, state)
        os.makedirs(best_dir, exist_ok=True)
        trainer.save(best_dir, state)
        with open(best_json, "w") as f:
            json.dump(best, f)

    key = state.key
    mined = None
    ema = state.params
    if resumed:
        # best.json lives OUTSIDE the restore try (round-2 ADVICE: a
        # missing best.json after a successful restore used to discard
        # the restored state and re-init at step 0).
        try:
            with open(best_json) as f:
                best = json.load(f)
        except (FileNotFoundError, OSError):
            best = dict(top1=-1.0, top10=-1.0, lrmsd=99.0, step=-1)
        # The EMA average and the persistent mined-negative buffer are
        # training state too (round-2 ADVICE: losing the buffer on
        # resume re-opens suppressed false positives until mining
        # rebuilds it).
        try:
            ema = trainer.restore(ema_dir).params
        except (FileNotFoundError, OSError):
            pass
        if os.path.exists(mined_npz):
            mined = load_mined(mined_npz)
        print(f"resumed at step {int(state.step)} (best: {best}; "
              f"mined buffer: "
              f"{sum(len(d.lrmsd) for d in (mined or {}).values())} "
              f"poses)", flush=True)

    @jax.jit
    def ema_update(e, p, d):
        return jax.tree_util.tree_map(lambda a, b: d * a + (1 - d) * b,
                                      e, p)

    def ema_decay_at(t):
        # Warmup-capped decay (the classic trick): early on the EMA
        # tracks the raw params so step-150 validation isn't dominated
        # by the shape-equivalent init.
        return min(ema_decay, (t + 1.0) / (t + 10.0))

    eval_params = lambda: ema if ema_decay > 0 else state.params
    t0 = time.perf_counter()
    for step in range(int(state.step), steps):
        if mine_every and step % mine_every == 0 and step > 0:
            # Rotate through the train set in chunks so each mining
            # round stays cheap; the persistent buffer accumulates
            # coverage across rounds.
            r = (step // mine_every - 1) * mine_chunk
            sub = [complexes[(r + i) % len(complexes)]
                   for i in range(min(mine_chunk, len(complexes)))]
            fresh = mine_hard_negatives(
                trainer.model, state.params, cfg, sub,
                n_rotations=mine_rots, top_k=24)
            mined = merge_mined(mined, fresh)
            # Free train-global proxy: best mined pose per complex is
            # the current model's global rank-1 neighborhood.
            t1 = float(np.mean([float(np.min(d.lrmsd)) < 4.0
                                for d in fresh.values()]))
            logger.log("mine", step=step, train_top24_hit=t1,
                       buffer=sum(len(d.lrmsd) for d in mined.values()))
        key, k_batch = jax.random.split(key)
        batch = make_training_batch(k_batch, complexes, cfg, mined=mined)
        state, metrics = trainer.train_step(state, batch)
        if ema_decay > 0:
            ema = ema_update(ema, state.params, ema_decay_at(step))
        loss = float(np.asarray(metrics["loss"]))
        acc = float(np.asarray(metrics["ranking_accuracy"]))
        logger.log("train_step", step=step, loss=loss,
                   ranking_accuracy=acc)
        if (step + 1) % val_every == 0 or step + 1 == steps:
            v1, v10, vb = val_global_hits(eval_params(), cfg, val_cplx,
                                          n_rot=val_nrot)
            logger.log("val", step=step + 1, top1=v1, top10=v10,
                       best_lrmsd=vb)
            print(f"step {step + 1}: loss={loss:.3f} acc={acc:.3f} "
                  f"val global top1={v1:.3f} top10={v10:.3f} "
                  f"lrmsd={vb:.2f} "
                  f"({(time.perf_counter() - t0):.0f}s)", flush=True)
            if (v1, v10, -vb) > (best["top1"], best["top10"],
                                 -best["lrmsd"]):
                best = dict(top1=v1, top10=v10, lrmsd=vb, step=step + 1)
                # The EMA weights are what validated; they're what the
                # best checkpoint ships (params slot of a normal
                # restore-compatible checkpoint).
                trainer.save(best_dir, state._replace(params=eval_params()))
                with open(best_json, "w") as f:
                    json.dump(best, f)
                print(f"  -> new best (saved)", flush=True)
            trainer.save(ckpt_dir, state)
            if ema_decay > 0:
                trainer.save(ema_dir, state._replace(params=ema))
            if mined:
                save_mined(mined_npz, mined)
    print(f"done; best val step {best['step']}: top1={best['top1']:.3f}"
          f" top10={best['top10']:.3f}")
    with open(os.path.join(ckpt_dir, "TRAINING.json"), "w") as f:
        json.dump(dict(steps=steps, grid=grid, mine_every=mine_every,
                       mine_rotations=mine_rots, n_train=n_train,
                       train_seed0=seed0,
                       unbound_rmsd=unbound, ema_decay=ema_decay,
                       n_val=n_val, val_seed0=val_seed0,
                       best_val=best,
                       curriculum="hybrid+local+global+persistent-mined"
                                  "+cosine-lr+valsel+ema"
                                  + (f"+unbound{unbound}" if unbound
                                     else "")),
                  f, indent=2)


if __name__ == "__main__":
    main()
