"""deeplocalproteindocking_tpu — protein-protein docking framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
lupoglaz/DeepLocalProteinDocking (+ its native dependency
lupoglaz/TorchProteinLibrary): atom-to-grid density splatting, a learned
3D-CNN local representation network, rotated-ligand grid resampling,
exhaustive per-rotation 3D-FFT translational correlation, and ranked
rigid-body pose extraction — trained end-to-end with a ranking loss whose
gradients flow through the voxelizer and the FFT correlator.

The reference is a single-GPU PyTorch research code built on custom
CUDA/C++ extensions; this framework is compiled by XLA for the GPU:

* volumes are channels-last ``[L, L, L, C]``,
* the SO(3) rotation sweep is one compiled ``lax.scan`` with a streaming
  top-K (no materialized rotation x translation score tensor),
* multi-device scaling is a ``jax.sharding.Mesh`` with ``shard_map`` over
  a ``(rot, batch)`` mesh — top-K merge is the only cross-device
  collective,
* the voxelizer is a matmul-form splat (no atomics), deterministic and
  exactly differentiable w.r.t. atom coordinates.

Layer map (mirrors SURVEY.md §1/§2 inventory):

* ``structure/``  — PDB parsing, 11-type atom typing, rigid transforms,
  SO(3) rotation sets                   (reference N1-N3, P4)
* ``grids/``      — differentiable voxelizer, volume rotation, XPLOR
  export                               (reference N4, N6, N8)
* ``correlate/``  — FFT translational correlation engine with cached
  receptor spectrum + channel coupling (reference N5, core of P2)
* ``models/``     — 3D-CNN representation + scoring nets (reference P1/P2)
* ``sweep/``      — rotation-scan docker, streaming top-K, pose
  clustering/NMS                       (reference P3, P5)
* ``parallel/``   — mesh + shard_map sweep (NEW: reference is single-GPU)
* ``train/``      — decoy generation, ranking loss, trainer (P7, P8)
* ``data/``       — benchmark dataset handling + synthetic fixtures (P6)
* ``utils/``      — RMSD/quality metrics, metrics logging, profiling (N7, P9 support)
"""

__version__ = "0.1.0"

from deeplocalproteindocking_tpu.config import DockConfig, PRESETS  # noqa: F401
