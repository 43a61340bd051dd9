"""Profiling hooks (SURVEY.md §5.1).

The reference has only ad-hoc timing prints; here the sweep and train
loops can be wrapped in ``jax.profiler.trace`` (TensorBoard/Perfetto
viewable) via a CLI ``--profile`` flag, and every pipeline stage carries
a ``jax.named_scope`` so traces segment by stage.
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Wrap a region in a profiler trace when ``trace_dir`` is set."""
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            yield
    else:
        yield


class StageTimer:
    """Host-side wall-clock timing of pipeline stages (blocks on device)."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *sync_arrays):
        t0 = time.perf_counter()
        yield
        for a in sync_arrays:
            jax.block_until_ready(a)
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)


def hlo_op_names(hlo_text: str) -> dict:
    """Instruction name -> ``op_name`` metadata (the named-scope path)
    of a compiled program's HLO text (``compiled.as_text()``)."""
    import re
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                     r'op_name="([^"]*)"', re.M)
    return {m.group(1): m.group(2) for m in pat.finditer(hlo_text)}


def device_scope_times(trace_dir: str, hlo_text: str, scopes: tuple,
                       plane_prefix: str = "/device:") -> dict:
    """Device time per named scope from a ``jax.profiler`` trace.

    Each device event names the HLO instruction it ran (``hlo_op``);
    :func:`hlo_op_names` maps that to its scope path.  Returns the
    summed device nanoseconds per scope (``other`` for instructions
    outside every scope, ``unattributed`` for events that name no
    instruction of the program), the busy time (union of the device
    intervals), the window from the first device event's start to the
    last one's end, and the event count.  ``plane_prefix`` picks the
    planes that hold device events (the CPU backend reports its ops on
    ``/host:CPU``).

    On the GPU, XLA replays runs of kernels as CUDA graphs ("command
    buffers"); the trace then shows one ``command_buffer`` event for the
    whole run, which lands in ``unattributed``.  A per-scope breakdown
    therefore runs with ``XLA_FLAGS=--xla_gpu_enable_command_buffer=``
    (``tools/measure_bringup.py --breakdown``).
    """
    import glob
    import os
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    names = hlo_op_names(hlo_text)
    ns = {s: 0 for s in scopes}
    ns["other"] = 0
    ns["unattributed"] = 0
    spans = []
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for e in line.events:
                op = dict(e.stats).get("hlo_op")
                if op is None:
                    continue
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
                path = names.get(op)
                hit = ("unattributed" if path is None else
                       next((s for s in scopes if s in path), "other"))
                ns[hit] += e.duration_ns
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (end - spans[0][0]) if spans else 0.0
    return dict(scope_ns=ns, busy_ns=busy, window_ns=window,
                n_events=len(spans))
