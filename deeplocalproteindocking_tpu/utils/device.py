"""What a measurement runs on: the JAX device and the card's power limit.

Every number a benchmark prints names its device.  A card may be set
below its maximum power and then runs slower under load, so the
``nvidia-smi`` name and power limit travel with each result.
"""
from __future__ import annotations

import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` gives
    them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu():
    """The JAX devices, or ``SystemExit`` when JAX finds no GPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is "
                         f"{backend!r}")
    return jax.devices()


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}
