"""Sweep-step measurements on a GPU: chunk size, engine, precision.

    python tools/measure_bringup.py [out.json]
    python tools/measure_bringup.py --breakdown [out.json]

One process, one card, flagship model (v9p: hybrid, 16 correlation
channels) at 128^3 on a 60/30-residue synthetic polymer complex:

1. ``chunk``: the largest power-of-two ``rotation_chunk`` whose
   full-rank f32 ``dft`` step compiles and runs (peak bytes from
   ``memory_analysis``).
2. ``steps``: time per rotation of the ``dft`` and ``xla`` engines at
   full rank and rank 3, f32 and bf16 DFT, at HIGHEST and DEFAULT
   matmul precision; device time per named scope (``fft_correlate``,
   ``streaming_topk``, ``ligand_cnn``, ``rotate_coords_resplat``) and
   the device idle share, from a profiler trace of a short window.
3. ``reference``: top-64 agreement of each engine/precision with the
   plain jnp.fft reference over 512 rotations (sweep/reference.py).

``--breakdown`` measures only the ``steps`` at HIGHEST, with XLA's
CUDA-graph command buffers off: a command buffer shows in the trace as
one event for a whole run of kernels, so the named scopes can only be
read without them (``utils/profiling.device_scope_times``).  Its step
times are of that program, not of the default one.

Exits non-zero when JAX finds no GPU or a step or reference
measurement raised (a chunk that does not fit is a result, not a
failure).  Writes one JSON file (default
``chiprun_out/bringup.json``, ``bringup_breakdown.json`` with
``--breakdown``) and prints it.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCOPES = ("rotate_coords_resplat", "ligand_cnn", "fft_correlate",
          "streaming_topk")


SIZE = dict(grid=128, n_rec=60, n_lig=30, chunks=(32, 64, 128),
            max_chunk=64, n_rot=1024, n_ref=512)


def _setup(impl="dft", dft_dtype="float32"):
    """(cfg, params, prep, lig, kw): the flagship complex prepared at
    the current precision."""
    import chip_smoke
    pipe, prep, lig, kw = chip_smoke.sweep_case(
        SIZE["grid"], SIZE["n_rec"], SIZE["n_lig"], fft_impl=impl,
        dft_dtype=dft_dtype)
    return pipe.config, pipe.params, prep, lig, kw


def _engine(cfg, params, prep, rank, impl):
    from deeplocalproteindocking_tpu.pipeline import DockingPipeline
    pipe = DockingPipeline(config=cfg.replace(coupling_rank=rank,
                                              fft_impl=impl),
                           params=params)
    _, _, rep_rec, _, coupling = prep
    return pipe._engine_parts(rep_rec, coupling)


def _set_precision(name):
    import jax
    from deeplocalproteindocking_tpu import numerics
    numerics.PRECISION = getattr(jax.lax.Precision, name)
    jax.clear_caches()


def measure_chunks(cfg, params, prep, lig, kw, chunks):
    import jax
    from deeplocalproteindocking_tpu.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_tpu.sweep.resplat import (
        dock_sweep_resplat)
    impl, H, rep_fn = _engine(cfg, params, prep, None, "dft")
    out = {}
    for chunk in chunks:
        rots = super_fibonacci_rotations(4 * chunk)
        try:
            comp = dock_sweep_resplat.lower(
                H, *lig, rots, rep_fn, chunk=chunk, fft_impl=impl,
                **kw).compile()
            mem = comp.memory_analysis()
            jax.block_until_ready(comp(H, *lig, rots))
            t0 = time.perf_counter()
            jax.block_until_ready(comp(H, *lig, rots))
            dt = time.perf_counter() - t0
            out[chunk] = dict(
                fits=True, ms_per_rotation=1e3 * dt / (4 * chunk),
                temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                arg_bytes=getattr(mem, "argument_size_in_bytes", None))
        except Exception as e:  # noqa: BLE001 — recorded as not fitting
            out[chunk] = dict(fits=False, error=str(e)[:300])
        print("chunk", chunk, out[chunk], flush=True)
    return out


def measure_step(cfg, params, prep, lig, kw, *, impl, rank, dft_dtype,
                 chunk, n_rot):
    import jax
    from deeplocalproteindocking_tpu.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_tpu.sweep.resplat import (
        dock_sweep_resplat)
    from deeplocalproteindocking_tpu.utils.profiling import (
        device_scope_times)
    impl, H, rep_fn = _engine(cfg, params, prep, rank, impl)
    rots = super_fibonacci_rotations(n_rot)
    comp = dock_sweep_resplat.lower(
        H, *lig, rots, rep_fn, chunk=chunk, fft_impl=impl,
        dft_dtype=dft_dtype, **kw).compile()
    jax.block_until_ready(comp(H, *lig, rots))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(comp(H, *lig, rots))
        times.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            jax.block_until_ready(comp(H, *lig, rots))
        prof = device_scope_times(td, comp.as_text(), SCOPES)
    win = prof["window_ns"] or 1.0
    return dict(ms_per_rotation=[1e3 * t / n_rot for t in times],
                rotations=n_rot, chunk=chunk,
                scope_ms_per_rotation={k: v / 1e6 / n_rot for k, v in
                                       prof["scope_ns"].items()},
                device_idle_share=1.0 - prof["busy_ns"] / win,
                trace_events=prof["n_events"])


STEPS = [("dft", None, "float32"), ("dft", 3, "float32"),
         ("dft", None, "bfloat16"), ("dft", 3, "bfloat16"),
         ("xla", None, "float32"), ("xla", 3, "float32")]


def main(argv):
    breakdown = "--breakdown" in argv
    argv = [a for a in argv if a != "--breakdown"]
    if breakdown:
        # Before JAX starts: the flag is read when the backend starts.
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_gpu_enable_command_buffer=")
    from deeplocalproteindocking_tpu.utils.device import require_gpu
    require_gpu()
    from deeplocalproteindocking_tpu.utils.cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    name = "bringup_breakdown.json" if breakdown else "bringup.json"
    path = argv[0] if argv else os.path.join(ROOT, "chiprun_out", name)
    res = (run_breakdown if breakdown else run)(path)
    failed = [k for sec in ("steps", "reference")
              for k, v in res.get(sec, {}).items() if "error" in v]
    if failed:
        print(f"measure_bringup: failed: {failed}", file=sys.stderr)
        return 1
    return 0


def _header():
    from deeplocalproteindocking_tpu.utils.device import (
        device_record, nvidia_smi_line)
    res = dict(card=nvidia_smi_line(), device=device_record(),
               size=SIZE)
    print(res, flush=True)
    return res


def _save(path, res):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def _steps(res, path, prec, chunk, only=None):
    cfg, params, prep, lig, kw = _setup()
    for impl, rank, dt in STEPS:
        if only and not only(impl, rank, dt):
            continue
        key = f"{impl}/rank{rank or 'full'}/{dt}/{prec}"
        try:
            res["steps"][key] = measure_step(
                cfg, params, prep, lig, kw, impl=impl, rank=rank,
                dft_dtype=dt, chunk=chunk, n_rot=SIZE["n_rot"])
        except Exception as e:  # noqa: BLE001 — recorded
            res["steps"][key] = dict(error=str(e)[:300])
        print(key, res["steps"][key], flush=True)
        _save(path, res)


def run_breakdown(path):
    """Step times and named-scope device times, command buffers off."""
    res = _header()
    res["command_buffers"] = False
    res["steps"] = {}
    _set_precision("HIGHEST")
    _steps(res, path, "HIGHEST", SIZE["max_chunk"])
    print(json.dumps(res))
    return res


def run(path):
    res = _header()
    _set_precision("HIGHEST")
    cfg, params, prep, lig, kw = _setup()
    res["lig_grid"] = kw["lig_grid"]
    res["chunk"] = measure_chunks(cfg, params, prep, lig, kw,
                                  SIZE["chunks"])
    fit = [c for c, r in res["chunk"].items() if r["fits"]]
    chunk = min(max(fit) if fit else 16, SIZE["max_chunk"])
    _save(path, res)
    res["steps"] = {}
    _set_precision("HIGHEST")
    _steps(res, path, "HIGHEST", chunk)
    _set_precision("DEFAULT")
    _steps(res, path, "DEFAULT", chunk,
           only=lambda impl, rank, dt: dt == "float32" and not rank)
    res["reference"] = {}
    for prec, impl, dt in [("HIGHEST", "dft", "float32"),
                           ("DEFAULT", "dft", "float32"),
                           ("HIGHEST", "dft", "bfloat16"),
                           ("HIGHEST", "xla", "float32"),
                           ("DEFAULT", "xla", "float32")]:
        key = f"{impl}/{dt}/{prec}"
        try:
            res["reference"][key] = _reference(impl, dt, prec, chunk)
        except Exception as e:  # noqa: BLE001 — recorded
            res["reference"][key] = dict(error=str(e)[:300])
        print(key, res["reference"][key], flush=True)
        _save(path, res)
    _set_precision("HIGHEST")
    print(json.dumps(res))
    return res


def _reference(impl, dft_dtype, prec, chunk):
    """Top-64 agreement of one engine/precision with the reference,
    which is traced at HIGHEST; the candidate prepares the complex and
    sweeps entirely at ``prec``."""
    from deeplocalproteindocking_tpu.structure.so3 import (
        super_fibonacci_rotations)
    from deeplocalproteindocking_tpu.sweep.reference import (
        reference_sweep, topk_agreement)
    from deeplocalproteindocking_tpu.sweep.resplat import (
        dock_sweep_resplat)
    rots = super_fibonacci_rotations(SIZE["n_ref"])
    _set_precision("HIGHEST")
    cfg, params, prep, lig, kw = _setup(impl, dft_dtype)
    _, H, rep_fn = _engine(cfg, params, prep, None, impl)
    ref, smax, score_at = reference_sweep(H, *lig, rots, rep_fn, **kw)
    _set_precision(prec)
    cfg, params, prep, lig, kw = _setup(impl, dft_dtype)
    impl, H, rep_fn = _engine(cfg, params, prep, None, impl)
    got = dock_sweep_resplat(H, *lig, rots, rep_fn, fft_impl=impl,
                             dft_dtype=dft_dtype, chunk=chunk, **kw)
    _set_precision("HIGHEST")
    agree = topk_agreement(ref, got, 1e-4 * smax, score_at)
    agree.update(max_abs_S=smax)
    return agree


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
