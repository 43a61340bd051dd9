"""GPU bring-up plumbing that the CPU can check: the compile-cache
placement, the smoke script's refusal without a GPU, engine names, the
plain-JAX model against a hand-written oracle, and the trace reducer."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.models.scoring import ScoringModel
from deeplocalproteindocking_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_the_variable(tmp_path, monkeypatch,
                                         restore_cache_config):
    want = str(tmp_path / "given")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert cache.cache_dir() == want
    assert cache.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_compile_cache_default_is_in_the_checkout(monkeypatch,
                                                  restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert cache.cache_dir() == want
    assert cache.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_refuses_cpu():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("engine", ["fused", "pallas", "fft"])
def test_config_rejects_unknown_engine(engine):
    text = DockConfig().to_json().replace('"dft"', f'"{engine}"')
    with pytest.raises(ValueError, match="unknown fft_impl"):
        DockConfig.from_json(text)


def test_scoring_model_matches_oracle():
    """Hybrid flagship shape: [surface, core] ++ bias-free CNN, with the
    block-diagonal coupling init; every f32 conv at HIGHEST."""
    from deeplocalproteindocking_tpu.models.representation import (
        shape_channels)
    m = ScoringModel(features=(6, 4), shape_prior=True)
    x = jnp.asarray(np.random.default_rng(0).random((10, 10, 10, 11)),
                    jnp.float32)
    p = m.init(jax.random.key(0), x, x)["params"]
    coup = np.zeros((6, 6), np.float32)
    coup[0, 0], coup[1, 1] = 1.0, -12.0
    np.testing.assert_array_equal(p["coupling"], coup)

    def conv(v, w):
        return jax.lax.conv_general_dilated(
            v[None], w, (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST)[0]

    cnn = p["representation"]["cnn"]
    h = jax.nn.elu(conv(x, cnn["conv0"]["kernel"]))
    want = jnp.concatenate([shape_channels(x)[0],
                            conv(h, cnn["conv1"]["kernel"])], axis=-1)
    rec, lig, c = m.apply({"params": p}, x, x)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(lig), np.asarray(want))
    got = m.apply({"params": p}, x, method=m.represent)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_device_scope_times_reads_a_trace(tmp_path):
    from deeplocalproteindocking_tpu.utils.profiling import (
        device_scope_times)

    @jax.jit
    def f(x):
        with jax.named_scope("fft_correlate"):
            y = jnp.fft.rfftn(x).real.sum()
        with jax.named_scope("streaming_topk"):
            z = jax.lax.top_k(x.reshape(-1), 4)[0].sum()
        return y + z

    x = jnp.ones((16, 16, 16))
    comp = f.lower(x).compile()
    comp(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        comp(x).block_until_ready()
    prof = device_scope_times(str(tmp_path), comp.as_text(),
                              ("fft_correlate", "streaming_topk"),
                              plane_prefix="/host:CPU")
    assert prof["n_events"] >= 2
    assert prof["scope_ns"]["fft_correlate"] > 0
    assert prof["scope_ns"]["streaming_topk"] > 0
    assert 0 < prof["busy_ns"] <= prof["window_ns"]


def test_cli_info_reports_devices_in_process(capsys, restore_cache_config):
    from deeplocalproteindocking_tpu import cli
    cli.main(["info"])
    out = capsys.readouterr().out
    assert "(cpu)" in out and "benchmark-4gpu" in out
