"""Pose clustering / non-maximum suppression by pairwise ligand RMSD.

Capability parity with the reference's pose post-processing
[U: DeepLocalProteinDocking/Docking — mount empty, unverified]: greedy
clustering of the ranked pose list, suppressing poses within an RMSD
radius of an already-accepted pose.

Design: the reference computes pairwise RMSDs with its CUDA
``Coords2RMSD`` op per pair.  For *rigid* poses of the same ligand the
pairwise RMSD has a closed form — with centered ligand coords X
(mean 0) and gyration matrix ``C = X^T X / N``:

    RMSD^2(i, j) = tr( (R_i - R_j) C (R_i - R_j)^T ) + ||t_i - t_j||^2

so the whole K x K matrix is a couple of einsums, no per-pair
superposition.  The greedy suppression itself is O(K^2) on K <= 128
scalars — host NumPy, off the hot path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.numerics import precision_for


def pose_pairwise_rmsd(lig_coords: jax.Array,
                       Rs: jax.Array, ts: jax.Array,
                       mask: jax.Array | None = None) -> jax.Array:
    """Closed-form pairwise RMSD matrix ``[K, K]`` for rigid poses.

    ``lig_coords [N, 3]`` (any frame — centered internally),
    ``Rs [K, 3, 3]``, ``ts [K, 3]``.
    """
    if mask is None:
        mask = jnp.ones(lig_coords.shape[0], dtype=lig_coords.dtype)
    w = mask.astype(lig_coords.dtype)
    n = jnp.maximum(w.sum(), 1.0)
    mu = (lig_coords * w[:, None]).sum(0) / n
    X = (lig_coords - mu) * w[:, None] ** 0.5
    hi = precision_for()
    C = jnp.matmul(X.T, X, precision=hi) / n            # [3, 3] gyration
    # Poses rotate about the ligand center: x -> R(x - mu) + mu + t, so
    # the center-offset between poses is exactly t_i - t_j.
    dR = Rs[:, None] - Rs[None, :]                      # [K, K, 3, 3]
    quad = jnp.einsum("abij,jk,abik->ab", dR, C, dR, precision=hi)
    dt = ts[:, None] - ts[None, :]
    sq = quad + jnp.sum(dt * dt, axis=-1)
    return jnp.sqrt(jnp.maximum(sq, 0.0))


def cluster_pose_set(lig_coords, poses, radius: float):
    """NMS-cluster a ``pipeline.PoseSet``; returns the clustered set.

    Shared by the sequential (pipeline.dock) and batched
    (evaluation.run_benchmark_batched) paths so both report comparable
    pose lists.
    """
    if len(poses.scores) <= 1:
        return poses
    D = pose_pairwise_rmsd(jnp.asarray(lig_coords),
                           jnp.asarray(poses.rotations),
                           jnp.asarray(poses.translations))
    keep = nms_cluster(poses.scores, D, radius)
    return type(poses)(scores=poses.scores[keep],
                       rotations=poses.rotations[keep],
                       translations=poses.translations[keep],
                       rot_idx=poses.rot_idx[keep],
                       shifts=poses.shifts[keep])


def nms_cluster(scores, rmsd_matrix, radius: float, max_out: int | None = None):
    """Greedy NMS: accept best-scoring pose, drop all within ``radius``.

    Returns indices of accepted poses (host NumPy int array, ranked).
    """
    scores = np.asarray(scores)
    D = np.asarray(rmsd_matrix)
    order = np.argsort(-scores)
    keep, suppressed = [], np.zeros(len(scores), dtype=bool)
    for i in order:
        if suppressed[i] or not np.isfinite(scores[i]):
            continue
        keep.append(int(i))
        suppressed |= D[i] < radius
        if max_out is not None and len(keep) >= max_out:
            break
    return np.asarray(keep, dtype=np.int64)
