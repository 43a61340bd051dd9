"""Characterize the block-decomposed correlation engine at 192/256 cubed.

SURVEY §5.7's long-context analog: grids whose spectra outgrow device
memory run the overlap-save block engine (correlate/blockfft.py).  It
is reachable end to end (192³ dock tested); this tool turns "works"
into "characterized" — wall-clock per rotation and device peak memory
at 192³ and 256³ on the card.

Usage: python tools/measure_256.py [n_rot] [grids]
Env: M256_CHUNK (rotation chunk, default 16), M256_BLOCK (fft_block).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from deeplocalproteindocking_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.data import synthetic_complex
from deeplocalproteindocking_tpu.pipeline import DockingPipeline


def peak_mb():
    try:
        stats = jax.local_devices()[0].memory_stats()
        return round(stats.get("peak_bytes_in_use", 0) / 2 ** 20)
    except Exception:  # noqa: BLE001 — platform-dependent introspection
        return None


def main():
    n_rot = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    grids = [int(g) for g in
             (sys.argv[2].split(",") if len(sys.argv) > 2
              else ["192", "256"])]
    chunk = int(os.environ.get("M256_CHUNK", 16))
    block = int(os.environ.get("M256_BLOCK", 64))
    # A large complex so the big box is physically meaningful
    # (~300-residue receptor fills a 256^3 x 1.25 A grid's core).
    cplx = synthetic_complex(seed=3, n_res_rec=120, n_res_lig=40)
    for grid in grids:
        cfg = DockConfig(grid_size=grid, resolution=1.25,
                         rep_features=(8,), num_rotations=n_rot,
                         rotation_chunk=chunk, top_k=32,
                         fft_impl="block", fft_block=block,
                         compute_dtype="bfloat16",
                         dft_dtype="bfloat16")
        pipe = DockingPipeline(config=cfg)
        t0 = time.perf_counter()
        poses = pipe.dock(cplx.receptor.centered(),
                          cplx.ligand.centered())
        np.asarray(poses.scores)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        poses = pipe.dock(cplx.receptor.centered(),
                          cplx.ligand.centered())
        np.asarray(poses.scores)
        warm = time.perf_counter() - t0
        print(json.dumps(dict(
            grid=grid, n_rot=n_rot, chunk=chunk, fft_block=block,
            cold_s=round(cold, 2), warm_s=round(warm, 2),
            ms_per_rot=round(warm / n_rot * 1e3, 2),
            peak_mb=peak_mb(),
            top_score=float(poses.scores[0]))), flush=True)


if __name__ == "__main__":
    main()
