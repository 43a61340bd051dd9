"""First-conv lowering knob (models/representation.conv1_lowered).

The sweep's CNN term is conv1-heavy (11 input channels); DLPD_CONV1
selects the lowering at trace time.  Requirements: the default path is
numerically IDENTICAL to a hand-written ``lax.conv`` stack (checkpoint-
format and value compatibility), pad16 is exact (zero channels
contribute exact zeros), patches matches to fp-reassociation
tolerance, and the param tree is the literal checkpoint layout so
existing checkpoints load unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplocalproteindocking_tpu.models.representation import (
    HybridRepresentation, Representation)


def _oracle(params, x, n_layers):
    """Plain stack: SAME 3x3x3 conv + bias, ELU between layers."""
    for i in range(n_layers):
        conv = params[f"conv{i}"]
        x = jax.lax.conv_general_dilated(
            x, conv["kernel"], (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST) + conv["bias"]
        if i + 1 < n_layers:
            x = jax.nn.elu(x)
    return x


@pytest.fixture()
def setup():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 12, 12, 12, 11)),
                    jnp.float32)
    model = Representation(features=(8, 6))
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    return model, params, x


def test_param_tree_matches_nn_conv(setup):
    model, params, x = setup
    shapes = jax.tree.map(lambda a: a.shape, params)
    assert shapes == {"conv0": {"kernel": (3, 3, 3, 11, 8), "bias": (8,)},
                      "conv1": {"kernel": (3, 3, 3, 8, 6), "bias": (6,)}}
    assert all(a.dtype == jnp.float32
               for a in jax.tree_util.tree_leaves(params))


def test_default_identical_to_nn_conv(setup, monkeypatch):
    monkeypatch.delenv("DLPD_CONV1", raising=False)
    model, params, x = setup
    got = model.apply({"params": params}, x)
    want = _oracle(params, x, 2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("impl", ["pad16", "patches"])
def test_lowerings_match_default(setup, monkeypatch, impl):
    # pad16's extra channels contribute exact zeros but lengthen the
    # contraction, so the reduction tree (and hence last-ulp rounding)
    # may differ; patches reassociates fully. Both must match to fp
    # tolerance.
    model, params, x = setup
    monkeypatch.delenv("DLPD_CONV1", raising=False)
    want = np.asarray(model.apply({"params": params}, x))
    monkeypatch.setenv("DLPD_CONV1", impl)
    got = np.asarray(model.apply({"params": params}, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_extra_batch_dims_fold(setup, monkeypatch):
    # vmapped/stacked callers present [B, chunk, L, L, L, C]; the
    # lowering conv folds leading dims.
    monkeypatch.setenv("DLPD_CONV1", "patches")
    model, params, x = setup
    x6 = jnp.stack([x, x * 0.5])
    got = model.apply({"params": params}, x6)
    want = jnp.stack([model.apply({"params": params}, x),
                      model.apply({"params": params}, x * 0.5)])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert got.shape == want.shape


def test_hybrid_checkpoint_tree_unchanged():
    x = jnp.zeros((1, 8, 8, 8, 11), jnp.float32)
    m = HybridRepresentation(features=(4, 3))
    p = m.init(jax.random.PRNGKey(0), x)["params"]
    assert set(p["cnn"]) == {"conv0", "conv1"}
    assert set(p["cnn"]["conv0"]) == {"kernel"}    # bias-free hybrid
    assert p["cnn"]["conv0"]["kernel"].shape == (3, 3, 3, 11, 4)


def test_gradients_flow_all_lowerings(setup, monkeypatch):
    model, params, x = setup
    for impl in ("xla", "pad16", "patches"):
        monkeypatch.setenv("DLPD_CONV1", impl)

        def loss(p):
            return jnp.sum(model.apply({"params": p}, x) ** 2)

        g = jax.grad(loss)(params)
        gk = np.asarray(g["conv0"]["kernel"])
        assert np.isfinite(gk).all() and np.abs(gk).max() > 0


class TestFoldedPathHonorsKnob:
    """The rank-truncated (folded-projection) rep_fn must go through
    the same conv1 lowering helper — round-5 review found the knob
    silently inert on the licensed rank-3 default, the one path the
    flagship actually runs."""

    def _pipe(self, rank):
        from deeplocalproteindocking_tpu.config import DockConfig
        from deeplocalproteindocking_tpu.pipeline import DockingPipeline
        cfg = DockConfig(grid_size=16, resolution=1.25,
                         rep_features=(8, 6), shape_prior=False,
                         num_rotations=4, rotation_chunk=2, top_k=4,
                         coupling_rank=rank)
        pipe = DockingPipeline(config=cfg)
        pipe.init_params(seed=0)
        return pipe

    def test_folded_rep_fn_calls_lowering_helper(self, monkeypatch):
        import deeplocalproteindocking_tpu.models.representation as R
        pipe = self._pipe(rank=2)
        calls = []
        orig = R.conv1_lowered
        monkeypatch.setattr(
            R, "conv1_lowered",
            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        _, rep_fn = pipe._spectral_parts_uncached(
            pipe.params["coupling"])
        vols = jnp.asarray(
            np.random.default_rng(0).random((2, 12, 12, 12, 11)),
            jnp.float32)
        rep_fn(vols)
        assert calls, "folded rep_fn bypassed conv1_lowered"

    @pytest.mark.parametrize("impl", ["pad16", "patches"])
    def test_folded_rep_fn_lowering_parity(self, monkeypatch, impl):
        pipe = self._pipe(rank=2)
        vols = jnp.asarray(
            np.random.default_rng(1).random((2, 12, 12, 12, 11)),
            jnp.float32)
        monkeypatch.delenv("DLPD_CONV1", raising=False)
        _, rep_fn = pipe._spectral_parts_uncached(
            pipe.params["coupling"])
        want = np.asarray(rep_fn(vols))
        monkeypatch.setenv("DLPD_CONV1", impl)
        _, rep_fn2 = pipe._spectral_parts_uncached(
            pipe.params["coupling"])
        got = np.asarray(rep_fn2(vols))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
