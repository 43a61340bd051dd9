"""Headline benchmark: per-complex full SO(3) x T docking sweep.

Target (BASELINE.md, driver-written north star): a full ~13k-rotation x
128^3-translation sweep per complex in < 10 s.  The script runs on the
GPUs JAX sees and rotation-shards across them when more than one is
visible; it exits non-zero when JAX finds no GPU.

The measured path is the flagship sweep: 11-type splat -> 3D-CNN
receptor representation -> cached coupled receptor spectrum ->
per-rotation [exact coordinate rotation -> matmul separable splat on
the ligand box -> CNN -> DFT correlation -> streaming top-K].

Prints ONE JSON line:
    {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": ...}
``vs_baseline`` = baseline_seconds / measured_seconds (>1 beats target);
a detail record (device, card name and power limit, rate) goes to
stderr.

Env knobs: BENCH_ROTATIONS, BENCH_GRID, BENCH_CHUNK, BENCH_FFT
("dft"|"xla"), BENCH_DTYPE ("float32", the precision checked against
the reference in PERF.md, | "bfloat16" for both the CNN and the DFT),
BENCH_RANK
(coupling_rank SVD truncation; default 3 — licensed round 4 by the
held-out 48-complex columns: rank-3 == full-rank == fp32 on every hit
decision, while rank-2 keeps the energy but drops 71% of the learned
coupling deviation and collapses top-1 below the shape baseline; 0
runs full-rank), BENCH_PROBE_ONLY=1.
"""
from __future__ import annotations

import json
import os
import sys
import time

BASELINE_SECONDS = 10.0


def _metric_name() -> str:
    """The workload's metric key: rotations, grid and rank, so numbers
    of a cheaper truncated-rank sweep never join the full-rank series."""
    n_rot = int(os.environ.get("BENCH_ROTATIONS", 13000))
    grid = int(os.environ.get("BENCH_GRID", 128))
    rank = int(os.environ.get("BENCH_RANK", 3)) or None
    rank_tag = "" if rank is None else f"_rank{rank}"
    return f"full_sweep_{n_rot}rot_{grid}grid{rank_tag}_wallclock"


def main():
    from deeplocalproteindocking_tpu.config import FULL_SWEEP_CHUNK
    n_rot = int(os.environ.get("BENCH_ROTATIONS", 13000))
    grid = int(os.environ.get("BENCH_GRID", 128))
    chunk = int(os.environ.get("BENCH_CHUNK", FULL_SWEEP_CHUNK))
    fft_impl = os.environ.get("BENCH_FFT", "dft")
    dft_dtype = os.environ.get("BENCH_DTYPE", "float32")
    rank = int(os.environ.get("BENCH_RANK", 3)) or None
    probe_only = os.environ.get("BENCH_PROBE_ONLY", "0") == "1"

    import jax
    from deeplocalproteindocking_tpu.utils.device import (
        device_record, nvidia_smi_line, require_gpu)
    devices = require_gpu()
    from deeplocalproteindocking_tpu.utils.cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    from deeplocalproteindocking_tpu.config import DockConfig
    from deeplocalproteindocking_tpu.correlate.fft import (
        receptor_transform)
    from deeplocalproteindocking_tpu.data import synthetic_complex
    from deeplocalproteindocking_tpu.data.benchmark import (
        structure_to_device)
    from deeplocalproteindocking_tpu.pipeline import DockingPipeline
    from deeplocalproteindocking_tpu.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_tpu.sweep.resplat import (
        auto_ligand_grid, dock_sweep_resplat)

    # Flagship model family (pretrained/synthetic-v4 .. v9p): hybrid
    # shape prior (2 analytic channels) ++ two bias-free 3^3 convs
    # (32, 14) = 16 correlation channels total.
    cfg = DockConfig(grid_size=grid, resolution=1.25,
                     rep_features=(32, 14), shape_prior=True,
                     compute_dtype=dft_dtype,
                     rotation_chunk=chunk, coupling_rank=rank,
                     top_k=64, fft_impl=fft_impl, dft_dtype=dft_dtype)
    pipe = DockingPipeline(config=cfg)
    params = pipe.init_params(seed=0)

    cplx = synthetic_complex(seed=0, n_res_rec=60, n_res_lig=30)
    rec_vol = pipe.voxelize(cplx.receptor.centered())
    rep_rec = pipe.model.apply({"params": params}, rec_vol,
                               method=pipe.model.represent)
    cpl_eff, rep_fn = pipe._spectral_parts(params["coupling"])
    H = receptor_transform(rep_rec, cpl_eff)
    lig_c = cplx.ligand.centered()
    lc, lt, lm = structure_to_device(lig_c)
    lig_grid = cfg.lig_grid_size or auto_ligand_grid(
        lig_c.typed().coords, cfg.resolution, cfg.sigma,
        pipe._receptive_field(), cfg.grid_size)

    n_dev = len(devices)
    mesh = None
    if n_dev > 1:
        from deeplocalproteindocking_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(rot=n_dev)

    kw = dict(grid_size=grid, lig_grid=lig_grid,
              resolution=cfg.resolution, sigma=cfg.sigma, num_types=11,
              top_k=cfg.top_k, chunk=chunk, fft_impl=fft_impl,
              dft_dtype=dft_dtype)

    def run(rotations):
        if mesh is not None:
            from deeplocalproteindocking_tpu.parallel.sharded_sweep \
                import sharded_dock_sweep_resplat
            res = sharded_dock_sweep_resplat(mesh, H, lc, lt, lm,
                                             rotations, rep_fn, **kw)
        else:
            res = dock_sweep_resplat(H, lc, lt, lm, rotations, rep_fn,
                                     **kw)
        return jax.block_until_ready(res)

    probe_n = min(max(8 * chunk, 128), n_rot)
    probe_rots = super_fibonacci_rotations(probe_n)
    run(probe_rots)                      # compile
    t0 = time.perf_counter()
    run(probe_rots)
    probe_t = time.perf_counter() - t0
    rate = probe_n / probe_t
    projected = n_rot / rate

    card = nvidia_smi_line()
    detail = {"probe_rotations": probe_n, "probe_seconds": probe_t,
              "rotations_per_second": rate, "lig_grid": lig_grid,
              "devices": n_dev, "fft_impl": fft_impl,
              "dft_dtype": dft_dtype, "chunk": chunk,
              "coupling_rank": rank, "device": device_record(),
              "card": card}

    if probe_only or projected > 900.0:
        value = projected
        detail["projected"] = True
    else:
        full_rots = super_fibonacci_rotations(n_rot)
        run(full_rots)                   # compile for the full scan
        t0 = time.perf_counter()
        run(full_rots)
        value = time.perf_counter() - t0
        detail["projected"] = False

    # vs_baseline is plain wall-clock on the devices actually visible;
    # device-seconds are reported beside it, no silent normalization.
    detail["wallclock_seconds"] = value
    detail["device_seconds"] = value * n_dev
    detail["target"] = (f"<{BASELINE_SECONDS}s per complex on {n_dev} "
                        f"x {card}")
    result = {
        "metric": _metric_name(),
        "value": round(value, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / value, 3),
        "coupling_rank": 0 if rank is None else rank,
        "device": card,
    }
    print(json.dumps(result))
    print(json.dumps({"detail": detail}), file=sys.stderr)


if __name__ == "__main__":
    main()
