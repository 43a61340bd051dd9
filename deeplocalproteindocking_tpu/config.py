"""Unified configuration for the docking framework.

The reference scatters hyperparameters across argparse scripts and model
files [U: DeepLocalProteinDocking train/dock scripts]; here a single
dataclass covers grid geometry, model width, sweep size, training, and the
device mesh, and is serialized alongside checkpoints.  The five
``BASELINE.json: configs`` entries become named presets in ``PRESETS``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


FFT_ENGINES = ("dft", "xla", "block")


@dataclasses.dataclass(frozen=True)
class DockConfig:
    # --- grid geometry (reference: TypedCoords2Volume args) ---
    grid_size: int = 128          # L: voxels per edge
    resolution: float = 1.25      # Angstrom per voxel
    sigma: float = 1.0            # Gaussian splat width (Angstrom)
    splat_window: int = 6         # voxels per axis of the local splat window
    num_atom_types: int = 11      # fixed by the 11-type chemistry table

    # --- representation model (reference: EQRepresentation) ---
    rep_features: Tuple[int, ...] = (32, 32, 16)  # conv widths; last = C_rep
    rep_kernel: int = 3
    shape_prior: bool = False     # hybrid model: analytic (surface,
                                  # core) channels ++ learned channels;
                                  # untrained == shape complementarity
    compute_dtype: str = "float32"   # "bfloat16" runs the CNN in bf16

    # --- sweep (reference: EQDocker + rotation sets) ---
    num_rotations: int = 13000
    rotation_chunk: int = 16      # rotations per scan step (batched FFTs)
    sweep_mode: str = "resplat"   # "resplat" (exact coordinate rotation)
                                  # | "resample" (reference-style rep rotation)
    lig_grid_size: Optional[int] = None  # ligand box; None = auto-fit
    fft_impl: str = "dft"         # "dft" (einsum matmul-DFT,
                                  #   correlate/dft.py)
                                  # | "xla" (jnp.fft)
                                  # | "block" (overlap-save block FFT,
                                  #   correlate/blockfft.py — O(M^3) peak
                                  #   memory; auto-selected when
                                  #   grid_size > 128 under the default
                                  #   impl)
    fft_block: int = 32           # translation-block edge for
                                  # fft_impl="block" (must divide
                                  # grid_size)
    dft_dtype: str = "float32"    # "bfloat16" trades precision for rate
    coupling_rank: Optional[int] = None
                                  # SVD-truncate the channel coupling to
                                  # rank r: ligand reps project to r
                                  # channels before the correlator, so
                                  # per-rotation forward-DFT/coupling
                                  # FLOPs scale with r instead of C
                                  # (pipeline._spectral_parts).  None =
                                  # exact full-rank scoring.
    topk_impl: str = "exact"      # "approx" = lax.approx_max_k (faster)
    top_k: int = 32               # poses kept per complex
    atom_bucket: int = 64         # pad atom counts to a multiple so
                                  # size-diverse benchmarks share
                                  # compiled sweeps (masked padding;
                                  # 0 = exact-size, one trace/complex)
    local_cone_deg: Optional[float] = None  # local docking: cone half-angle
    nms_rmsd: float = 5.0         # greedy clustering suppression radius (A)

    # --- training (reference: ranking hinge trainer) ---
    num_decoys: int = 32          # decoys per complex per step
    hinge_margin: float = 1.0
    near_native_rmsd: float = 5.0  # LRMSD below which a decoy is "positive"
    decoy_max_angle_deg: float = 60.0
    decoy_max_shift: float = 12.0  # Angstrom
    decoy_global_frac: float = 0.0  # fraction of decoys drawn GLOBALLY
                                    # (full SO(3) x box-wide shifts) —
                                    # required for global-docking wins
    mined_frac: float = 0.25        # fraction replaced by FFT-mined hard
                                    # negatives when a buffer is supplied
    learning_rate: float = 1e-3
    lr_decay_steps: int = 0       # >0: cosine-decay learning_rate to
                                  # 10% over this many steps (stabilizes
                                  # the mined-negative min-max loop)
    weight_decay: float = 0.0     # AdamW decoupled weight decay
    batch_complexes: int = 2      # complexes per train step
    augment_rotations: bool = True  # joint SO(3) augmentation per sample
                                    # (the reference's EQ models rely on
                                    # rotational augmentation [P])

    # --- mesh (NEW vs reference: it was single-GPU, SURVEY.md §2.3) ---
    mesh_rot: int = 1             # devices along the rotation axis
    mesh_batch: int = 1           # devices along the complex/data axis

    # --- misc ---
    seed: int = 0
    debug_nans: bool = False   # jax_debug_nans guard (SURVEY.md §5.2)

    def __post_init__(self):
        if self.fft_impl not in FFT_ENGINES:
            raise ValueError(
                f"unknown fft_impl {self.fft_impl!r}; the correlator "
                f"engines are {FFT_ENGINES}")

    @property
    def c_rep(self) -> int:
        return self.rep_features[-1]

    @property
    def box_extent(self) -> float:
        return self.grid_size * self.resolution

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "DockConfig":
        d = json.loads(text)
        d["rep_features"] = tuple(d.get("rep_features", cls.rep_features))
        return cls(**d)

    def replace(self, **kw) -> "DockConfig":
        return dataclasses.replace(self, **kw)


# Rotations per scan step of the 128^3 sweep, measured on one 80 GB
# H100 (PERF.md, "Bring-up measurements"): 32, 64 and 128 all fit at
# full rank in f32; 32 and 64 tie and 128 is slower, so the largest
# chunk that loses no speed.
FULL_SWEEP_CHUNK = 64

# The five BASELINE.json configs as named presets.
PRESETS = {
    # configs[0]: single-complex rigid FFT docking, shape channels only,
    # coarse ~100 rotations, 64^3 grid (CPU-checkable).
    "tiny-shape": DockConfig(
        grid_size=64, resolution=1.5, num_rotations=96, rotation_chunk=8,
        top_k=16, rep_features=(8,),
    ),
    # configs[1]: learned multi-channel representation scoring, one
    # rotation batch, pretrained weights.
    "rep-score": DockConfig(
        grid_size=96, num_rotations=16, rotation_chunk=16, top_k=16,
    ),
    # configs[2]: full-resolution sweep with streaming top-K + NMS.
    # rotation_chunk: see FULL_SWEEP_CHUNK.
    "full-sweep": DockConfig(
        grid_size=128, num_rotations=13000,
        rotation_chunk=FULL_SWEEP_CHUNK, top_k=64,
    ),
    # configs[3]: end-to-end representation training.
    "train": DockConfig(
        grid_size=96, num_rotations=512, rotation_chunk=8,
        num_decoys=32, batch_complexes=2,
    ),
    # configs[4]: batched multi-complex benchmark eval, rotations
    # sharded over the four GPUs of one host.
    "benchmark-4gpu": DockConfig(
        grid_size=128, num_rotations=13000, rotation_chunk=16, top_k=64,
        mesh_rot=4, mesh_batch=1,
    ),
}
