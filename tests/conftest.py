"""Test harness: force JAX onto a virtual 8-device CPU platform.

SURVEY.md §4: JAX's CPU backend with
``--xla_force_host_platform_device_count=8`` is the "fake cluster" —
the same ``shard_map`` code paths that run on a multi-GPU host run here
in CI, so rotation-sharding and top-K-merge logic are testable without
GPUs.  Must run before the first ``import jax`` anywhere in the test
session.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
jax.config.update("jax_default_matmul_precision", "highest")


# ---------------------------------------------------------------------------
# Fast/slow test tiers (round-2 VERDICT weak #8: the 19-minute full
# suite taxed every iteration).  Heavy modules are marked slow here so
# `pytest -m "not slow"` gives a <3-minute unit tier; anything not
# listed runs in both tiers.  Module-level marking keeps the tier
# decision in one place instead of scattered decorators.
# ---------------------------------------------------------------------------
import pytest  # noqa: E402

_SLOW_MODULES = {
    "test_e2e",          # full-stack docking sweeps
    "test_golden",       # golden sweep snapshots (two engines)
    "test_parallel",     # 8-device mesh == single-device sweeps
    "test_pretrained",   # checkpoint loading + eval sweeps
    "test_train",        # training loops with FD gradient checks
    "test_blockfft",     # 192^3 end-to-end dock
    "test_resplat",      # sweep oracles + FD grads through splat->CNN->FFT
    "test_hybrid",       # shape-prior equivalence sweeps
    "test_cli",          # subprocess CLI invocations
    "test_properties",   # hypothesis sweeps (25 examples x property)
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
