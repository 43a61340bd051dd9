"""Device-mesh construction for the (rot, batch) parallel axes.

NEW relative to the reference, which is single-process single-GPU with
no distributed layer at all (SURVEY.md §2.3).  The workload's natural
parallel axes are:

* ``rot``   — the SO(3) rotation set of the docking sweep
              (embarrassingly parallel; only a top-K merge collective);
* ``batch`` — complexes (benchmark eval) / training data parallelism.

XLA inserts the collectives from the sharding specs and hands them to
the GPU's collective library (NCCL over NVLink within a host) — no
custom transport.
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_mesh(rot: int = 1, batch: int = 1,
              devices=None) -> Mesh:
    """A ``(rot, batch)`` mesh over the first ``rot * batch`` devices."""
    devices = list(devices if devices is not None else jax.devices())
    need = rot * batch
    if len(devices) < need:
        raise ValueError(
            f"mesh rot={rot} x batch={batch} needs {need} devices, "
            f"have {len(devices)}")
    import numpy as np
    arr = np.asarray(devices[:need]).reshape(rot, batch)
    return Mesh(arr, axis_names=("rot", "batch"))
