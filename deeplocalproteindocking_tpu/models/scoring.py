"""Scoring model: shared representation net + learned channel coupling.

Capability parity with the reference's ``EQScoringModel``
[U: DeepLocalProteinDocking/Models/EQScoringModel.py — mount empty,
unverified]: receptor and ligand share one representation network, and
the docking score of a pose (R, t) is a PIPER-style sum over channel
pairs of translational correlations between ``rep(rec)`` and
``rep(rotate(lig, R))``, with a learned coupling between channels.

The coupling is a full ``[C_rep, C_rep]`` matrix (the most general of
the schemes the reference lineage uses), initialized to the identity so
an untrained model scores pure multi-channel shape complementarity.
The actual sweep lives in ``sweep/docker.py`` as pure functions of
``(rep_rec, rep_lig, coupling)`` — the module only owns parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from deeplocalproteindocking_tpu.models.representation import (
    HybridRepresentation, Module, Representation, shape_channels,
)


def _shape_block_coupling(c: int) -> jnp.ndarray:
    """Block-diagonal init for the hybrid model: the 2x2 shape-
    complementarity coupling in the prior block, ZEROS elsewhere —
    so the untrained hybrid scores EXACTLY classic shape
    complementarity (the learned channels contribute nothing until
    the ranking loss moves the coupling off zero)."""
    m = jnp.zeros((c, c), jnp.float32)
    return m.at[:2, :2].set(shape_channels(jnp.zeros((4, 4, 4, 1)))[1])


@dataclasses.dataclass(frozen=True)
class ScoringModel(Module):
    """Params: ``{"coupling": [C, C], "representation": ...}``."""
    features: Tuple[int, ...] = (32, 32, 16)
    kernel: int = 3
    dtype: Any = jnp.float32
    shape_prior: bool = False    # hybrid: analytic (surface, core)
                                 # channels ++ learned CNN channels

    @property
    def representation(self):
        if self.shape_prior:
            return HybridRepresentation(features=self.features,
                                        kernel=self.kernel,
                                        dtype=self.dtype)
        return Representation(features=self.features, kernel=self.kernel,
                              dtype=self.dtype)

    def init_params(self, key: jax.Array, in_channels: int) -> dict:
        if self.shape_prior:
            coupling = _shape_block_coupling(self.features[-1] + 2)
        else:
            coupling = jnp.eye(self.features[-1], dtype=jnp.float32)
        return {"coupling": coupling,
                "representation": self.representation.init_params(
                    key, in_channels)}

    def __call__(self, params: dict, rec_vol: jnp.ndarray,
                 lig_vol: jnp.ndarray):
        """Returns (rep_rec, rep_lig, coupling) for the sweep/trainer."""
        rep_rec = self.represent(params, rec_vol)
        rep_lig = self.represent(params, lig_vol)
        return rep_rec, rep_lig, params["coupling"]

    def represent(self, params: dict, vol: jnp.ndarray) -> jnp.ndarray:
        return self.representation(params["representation"], vol)
