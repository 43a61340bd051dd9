"""Learned 3-D CNN local representation network.

Capability parity with the reference's ``EQRepresentation``
[U: DeepLocalProteinDocking/Models/EQRepresentation.py — mount empty,
unverified]: a small stack of 3x3x3 3-D convolutions mapping the 11-type
density volume to a C_rep-channel learned representation.  Rotational
behavior comes from data augmentation, not architectural equivariance
(paper bioRxiv 738690) — so a plain conv stack is the faithful capability.

Plain JAX: a model is a frozen dataclass of hyperparameters whose
parameters are a nested dict, ``{"conv<i>": {"kernel": [k, k, k, C_in,
C_out], "bias": [C_out]}}`` (LeCun-normal kernels, zero biases).
``init(key, x)`` returns ``{"params": ...}`` and ``apply({"params": p},
x)`` runs it.  Volumes are channels-last ``[..., L, L, L, C]``; a
``dtype`` knob runs the convs in bfloat16 (params stay float32,
outputs are cast back).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.numerics import precision_for

_DN = ("NDHWC", "DHWIO", "NDHWC")


class Module:
    """The ``init``/``apply`` call shape shared by the models."""

    def init_params(self, key: jax.Array, in_channels: int) -> dict:
        raise NotImplementedError

    def init(self, key: jax.Array, x: jnp.ndarray, *_) -> dict:
        return {"params": self.init_params(key, x.shape[-1])}

    def apply(self, variables: dict, *args, method=None):
        fn = self.__call__ if method is None else method
        return fn(variables["params"], *args)


def shape_channels(vol: jnp.ndarray, *, core_weight: float = 12.0,
                   threshold: float = 0.35, shell: int = 2):
    """Analytic (surface, core) channels from a density volume.

    ``vol [..., L, L, L, T] -> [..., L, L, L, 2]``: core = occupancy
    above threshold, surface = ``shell``-voxel dilation minus core —
    ZDOCK-style shape complementarity with the canonical coupling
    ``[[1, 0], [0, -core_weight]]`` (surface-surface attracts,
    core-core repels).  Used standalone (pipeline shape mode) and as
    the physical prior inside :class:`HybridRepresentation`.
    """
    occ = vol.sum(-1)
    core = (occ > threshold).astype(jnp.float32)
    w = 2 * shell + 1
    batch = core.ndim - 3
    # Cube dilation is separable: three 1-D max-pools cost O(3w) per
    # voxel instead of O(w^3) — this runs per rotation on the sweep hot
    # path (measured 0.29 -> ~0.1 ms/rotation at 40^3 x chunk 16).
    dil = core
    for ax in range(3):
        win = [1] * core.ndim
        win[batch + ax] = w
        dil = jax.lax.reduce_window(dil, -jnp.inf, jax.lax.max,
                                    tuple(win), (1,) * core.ndim,
                                    "SAME")
    surface = dil - core
    rep = jnp.stack([surface, core], axis=-1)
    coupling = jnp.array([[1.0, 0.0], [0.0, -core_weight]], jnp.float32)
    return rep, coupling


def conv3d(x: jnp.ndarray, w: jnp.ndarray,
           b: jnp.ndarray | None = None) -> jnp.ndarray:
    """SAME 3-D conv of ``x [..., L, L, L, C_in]`` with ``w [k, k, k,
    C_in, C_out]``; leading dims beyond one batch axis are folded."""
    lead = x.shape[:-4]
    x = x.reshape((-1,) + x.shape[-4:])
    y = jax.lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=_DN,
        precision=precision_for(x.dtype))
    if b is not None:
        y = y + b.astype(y.dtype)
    return y.reshape(lead + y.shape[1:])


def conv1_lowered(x: jnp.ndarray, w: jnp.ndarray,
                  b: jnp.ndarray | None = None) -> jnp.ndarray:
    """First-layer 3-D conv with the ``DLPD_CONV1``-selected lowering.

    Shared by :class:`Representation` and ``pipeline._folded_rep_fn``
    (the rank-truncated fast path) so the knob is honored on BOTH
    production paths.

    The sweep's per-rotation CNN cost is conv1-heavy: its input is the
    11-type density, an odd channel count for the convolution
    libraries.  Lowerings (selected at trace time from ``DLPD_CONV1``,
    so changing it inside a process does not affect already-compiled
    programs):

      xla      lax.conv_general_dilated as-is (default — candidates
               are only promoted after tools/exp_conv1.py measures a
               win on the card)
      pad16    zero-pad C_in -> 16 on both input and kernel before the
               same conv (numerically identical — padded channels
               contribute exact zeros)
      patches  explicit im2col: conv_general_dilated_patches -> one
               [N*L^3, 27*C_in] x [27*C_in, C_out] GEMM

    ``x`` is ``[..., L, L, L, C_in]`` (extra leading dims folded);
    ``w`` is ``[kx, ky, kz, C_in, C_out]``; ``b`` is added in ``x``'s
    compute dtype when given.
    """
    import os
    impl = os.environ.get("DLPD_CONV1", "xla")
    if impl == "pad16":
        pad = (-x.shape[-1]) % 16
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        w = jnp.pad(w, [(0, 0)] * 3 + [(0, pad), (0, 0)])
    elif impl == "patches":
        lead = x.shape[:-4]
        x = x.reshape((-1,) + x.shape[-4:])
        p = jax.lax.conv_general_dilated_patches(
            x, w.shape[:3], (1, 1, 1), "SAME", dimension_numbers=_DN,
            precision=precision_for(x.dtype))
        # patches feature order is (C_in, *kernel_spatial):
        # fold the kernel to match (parity-tested vs xla).
        wf = w.transpose(3, 0, 1, 2, 4).reshape(-1, w.shape[-1])
        y = jnp.matmul(p, wf, precision=precision_for(x.dtype))
        if b is not None:
            y = y + b.astype(y.dtype)
        return y.reshape(lead + y.shape[1:])
    return conv3d(x, w, b)


@dataclasses.dataclass(frozen=True)
class Representation(Module):
    features: Tuple[int, ...] = (32, 32, 16)
    kernel: int = 3
    dtype: Any = jnp.float32
    use_bias: bool = True

    def init_params(self, key: jax.Array, in_channels: int) -> dict:
        init = jax.nn.initializers.lecun_normal()
        params = {}
        cin = in_channels
        for i, (f, k) in enumerate(zip(self.features, jax.random.split(
                key, len(self.features)))):
            conv = {"kernel": init(k, (self.kernel,) * 3 + (cin, f),
                                   jnp.float32)}
            if self.use_bias:
                conv["bias"] = jnp.zeros((f,), jnp.float32)
            params[f"conv{i}"] = conv
            cin = f
        return params

    def __call__(self, params: dict, vol: jnp.ndarray) -> jnp.ndarray:
        """``[..., L, L, L, C_in] -> [..., L, L, L, C_rep]``."""
        squeeze = vol.ndim == 4
        x = vol[None] if squeeze else vol
        x = x.astype(self.dtype)
        for i in range(len(self.features)):
            conv = params[f"conv{i}"]
            w = conv["kernel"].astype(self.dtype)
            b = conv.get("bias")
            b = None if b is None else b.astype(self.dtype)
            x = conv1_lowered(x, w, b) if i == 0 else conv3d(x, w, b)
            if i + 1 < len(self.features):
                x = jax.nn.elu(x)
        x = x.astype(jnp.float32)
        return x[0] if squeeze else x


@dataclasses.dataclass(frozen=True)
class HybridRepresentation(Module):
    """Learned residual on an analytic shape prior.

    Output channels = ``[surface, core] ++ CNN(features)``.  With the
    matching block-diagonal coupling init (models/scoring.py), the
    UNTRAINED model scores exactly classic shape complementarity; the
    ranking loss then trains the CNN channels and the full coupling to
    correct it — so "learned beats shape" is the training objective's
    zero point, not a hope.  The shape branch uses non-differentiable
    threshold/dilation (gradients flow through the learned branch and
    the coupling only), mirroring how the reference's learned scoring
    competes against fixed physical terms [P: bioRxiv 738690].

    BIAS-FREE CNN: with biases, learned channels are nonzero over the
    whole empty box (ELU(bias) background), so their correlations carry
    a volume-overlap term that swamps ranking on complexes of unseen
    size (measured: a biased hybrid DEGRADED held-out global top-1 from
    0.875 to 0.25).  Bias-free convs keep learned features supported
    near atoms, like the physical channels.  Params: ``{"cnn": ...}``.
    """
    features: Tuple[int, ...] = (32, 16)
    kernel: int = 3
    dtype: Any = jnp.float32

    @property
    def cnn(self) -> Representation:
        return Representation(features=self.features, kernel=self.kernel,
                              dtype=self.dtype, use_bias=False)

    def init_params(self, key: jax.Array, in_channels: int) -> dict:
        return {"cnn": self.cnn.init_params(key, in_channels)}

    def __call__(self, params: dict, vol: jnp.ndarray) -> jnp.ndarray:
        learned = self.cnn(params["cnn"], vol)
        prior, _ = shape_channels(vol)
        return jnp.concatenate([prior, learned], axis=-1)
