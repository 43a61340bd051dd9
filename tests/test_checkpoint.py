"""npz checkpoints: round trip, the converted flagship, and the main path
with flax and orbax unavailable."""
import hashlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.train import Trainer
from deeplocalproteindocking_tpu.train.trainer import (
    checkpoint_steps, flatten_state, unflatten_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "pretrained", "synthetic-v9p", "best")
# sha256 over (name, bytes) of the flagship's params, sorted by name, as
# restored from the original checkpoint before its conversion to npz.
FLAGSHIP_SHA256 = ("57e03112cd19c7fcd3e5f55180b37eb0"
                   "6bb9e785a5aa9e9452b2348295fb702f")


def _cfg():
    return DockConfig(grid_size=16, resolution=1.5, rep_features=(4, 3),
                      shape_prior=True, weight_decay=1e-4)


def test_npz_round_trip(tmp_path):
    tr = Trainer(_cfg())
    state = tr.init_state(seed=3)
    state = state._replace(step=state.step + 7)
    path = tr.save(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000007.npz"
    assert checkpoint_steps(str(tmp_path)) == [7]
    back = tr.restore(str(tmp_path))
    a = flatten_state(dict(params=state.params, opt_state=state.opt_state))
    b = flatten_state(dict(params=back.params, opt_state=back.opt_state))
    assert a.keys() == b.keys()
    assert "params/representation/cnn/conv0/kernel" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    assert int(back.step) == 7
    np.testing.assert_array_equal(jax.random.key_data(back.key),
                                  jax.random.key_data(state.key))
    assert DockConfig.from_json(
        open(tmp_path / "config.json").read()) == _cfg()


def test_restore_rejects_other_model_shape(tmp_path):
    tr = Trainer(_cfg())
    tr.save(str(tmp_path), tr.init_state())
    with pytest.raises(ValueError, match="shape"):
        Trainer(_cfg().replace(rep_features=(4, 5))).restore(
            str(tmp_path))
    with pytest.raises(KeyError, match="conv2"):
        unflatten_state({"conv2": np.zeros(1)}, {}, "empty")


def test_converted_flagship_matches_checksum():
    with open(os.path.join(FLAGSHIP, "config.json")) as f:
        cfg = DockConfig.from_json(f.read())
    assert cfg.fft_impl == "dft"
    state = Trainer(cfg).restore(FLAGSHIP)
    assert int(state.step) == 500
    flat = flatten_state(dict(params=state.params))
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    assert h.hexdigest() == FLAGSHIP_SHA256
    assert jax.tree.map(np.shape, state.params) == {
        "coupling": (16, 16),
        "representation": {"cnn": {
            "conv0": {"kernel": (3, 3, 3, 11, 32)},
            "conv1": {"kernel": (3, 3, 3, 32, 14)}}}}


_BLOCKED = """
import sys
sys.modules["flax"] = sys.modules["orbax"] = None
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.data import synthetic_complex
from deeplocalproteindocking_tpu.pipeline import DockingPipeline
from deeplocalproteindocking_tpu.train import Trainer
ck = sys.argv[1]
cfg = DockConfig.from_json(open(ck + "/config.json").read())
state = Trainer(cfg).restore(ck)
pipe = DockingPipeline(config=cfg.replace(num_rotations=4,
                                          rotation_chunk=2, top_k=4),
                       params=state.params)
poses = pipe.dock_complex(synthetic_complex(seed=5, n_res_rec=8,
                                            n_res_lig=4), cluster=False)
assert np.isfinite(poses.scores).all() and len(poses) == 4
mods = [m for m in sys.modules if m.split(".")[0] in ("flax", "orbax")
        and sys.modules[m] is not None]
assert not mods, mods
print("BLOCKED_OK")
"""


def test_dock_and_restore_without_flax_or_orbax():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED,
         os.path.join(ROOT, "pretrained", "synthetic-v1")],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BLOCKED_OK" in r.stdout
