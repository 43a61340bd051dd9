"""Measure 8-way rotation-sharding overhead on the virtual CPU mesh.

This tool measures what can be measured without 8 real devices — the
cost the
sharded program adds over the same per-shard work run unsharded (the
all-gather top-K merge + shard_map machinery), and the per-shard skew
(rotation-count imbalance).  Virtual CPU devices share host cores, so
absolute times are not device times; the *delta* between
`sharded(8, N)` and `unsharded(N/8)` isolates the merge/dispatch
overhead, and the gathered payload size bounds the interconnect cost
on real hardware.

Usage: XLA not preconfigured — the script forces an 8-device CPU
platform itself.  python tools/measure_scaling.py [n_rot]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.correlate.fft import receptor_transform
from deeplocalproteindocking_tpu.data import synthetic_complex
from deeplocalproteindocking_tpu.data.benchmark import structure_to_device
from deeplocalproteindocking_tpu.parallel.mesh import make_mesh
from deeplocalproteindocking_tpu.parallel.sharded_sweep import (
    sharded_dock_sweep_resplat)
from deeplocalproteindocking_tpu.pipeline import DockingPipeline
from deeplocalproteindocking_tpu.structure.so3 import (
    super_fibonacci_rotations)
from deeplocalproteindocking_tpu.sweep.resplat import (
    auto_ligand_grid, dock_sweep_resplat)


def main():
    n_rot = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    chunk, top_k, grid = 8, 64, 48
    cfg = DockConfig(grid_size=grid, resolution=1.25,
                     rep_features=(8,), rotation_chunk=chunk,
                     top_k=top_k, fft_impl="dft")
    pipe = DockingPipeline(config=cfg)
    params = pipe.init_params(seed=0)
    cplx = synthetic_complex(seed=0, n_res_rec=20, n_res_lig=10)
    rec_vol = pipe.voxelize(cplx.receptor.centered())
    rep_rec = pipe.model.apply({"params": params}, rec_vol,
                               method=pipe.model.represent)
    H = receptor_transform(rep_rec, params["coupling"])
    lig_c = cplx.ligand.centered()
    lc, lt, lm = structure_to_device(lig_c)
    lig_grid = auto_ligand_grid(lig_c.typed().coords, cfg.resolution,
                                cfg.sigma, pipe._receptive_field(),
                                grid)
    rep_fn = pipe._ligand_rep_fn()
    kw = dict(grid_size=grid, lig_grid=lig_grid,
              resolution=cfg.resolution, sigma=cfg.sigma, num_types=11,
              top_k=top_k, chunk=chunk, fft_impl="dft")

    mesh = make_mesh(rot=8)
    rots_full = super_fibonacci_rotations(n_rot)
    rots_shard = super_fibonacci_rotations(n_rot // 8)

    def t(fn, reps=3):
        fn()  # compile
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    t_shard8 = t(lambda: np.asarray(sharded_dock_sweep_resplat(
        mesh, H, lc, lt, lm, rots_full, rep_fn, **kw).scores))
    t_full = t(lambda: np.asarray(dock_sweep_resplat(
        H, lc, lt, lm, rots_full, rep_fn, **kw).scores))
    t_one = t(lambda: np.asarray(dock_sweep_resplat(
        H, lc, lt, lm, rots_shard, rep_fn, **kw).scores))
    # Virtual devices SERIALIZE on shared host cores, so the honest
    # comparison is sharded(8, N) vs unsharded(1, N): same total
    # compute, delta = shard_map + all-gather merge machinery.
    # Per-shard skew: rotations per device after chunk-padding.
    per_shard = -(-n_rot // (8 * chunk)) * chunk
    counts = [max(0, min(per_shard, n_rot - d * per_shard))
              for d in range(8)]
    payload = 8 * top_k * (4 + 4 + 12)   # scores f32 + rot i32 + shift 3xi32
    print(f"n_rot={n_rot} grid={grid} devices=8 (virtual CPU, "
          f"serialized on shared cores)")
    print(f"sharded(8 dev, {n_rot} rot):   {t_shard8 * 1e3:8.1f} ms")
    print(f"unsharded(1 dev, {n_rot} rot): {t_full * 1e3:8.1f} ms")
    print(f"unsharded(1 dev, {n_rot // 8} rot): {t_one * 1e3:8.1f} ms "
          f"(ideal per-chip work)")
    print(f"shard_map + merge overhead: {(t_shard8 - t_full) * 1e3:8.1f}"
          f" ms ({(t_shard8 / t_full - 1) * 100:.1f}% of equal-compute "
          f"unsharded)")
    print(f"per-shard rotation counts (skew): {counts}")
    print(f"all-gather payload: {payload} bytes total "
          f"({top_k} candidates x 20 B x 8 shards)")


if __name__ == "__main__":
    main()
