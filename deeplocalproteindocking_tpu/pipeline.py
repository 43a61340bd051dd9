"""End-to-end docking pipeline: structures in, ranked poses out.

This is the call stack of SURVEY.md §3.1 as one object:

    parse/type (structure/) -> splat (grids/) -> represent (models/)
    -> sweep (sweep/ or parallel/) -> cluster (sweep/cluster)
    -> quality (utils/quality)

Two scoring modes:

* **learned** — the 3D-CNN representation + learned channel coupling
  (reference EQScoringModel path);
* **shape** — no CNN: two analytic channels (surface shell, core) with a
  fixed attract/repulse coupling, the classic FFT-docking shape
  complementarity (BASELINE.json configs[0] "shape-complementarity
  channels only").

Geometry: receptor centered at origin; ligand centered at its own
center; a pose is ``x -> R x + shift * resolution`` (see train/decoys.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.correlate.fft import (
    coupled_receptor, resolve_engine,
)
from deeplocalproteindocking_tpu.data.benchmark import (
    Complex, structure_to_device,
)
from deeplocalproteindocking_tpu.grids.voxelize import separable_splat
from deeplocalproteindocking_tpu.models.scoring import ScoringModel
from deeplocalproteindocking_tpu.numerics import precision_for
from deeplocalproteindocking_tpu.parallel.sharded_sweep import (
    sharded_dock_sweep,
)
from deeplocalproteindocking_tpu.structure.pdb import Structure
from deeplocalproteindocking_tpu.structure.so3 import (
    local_rotations, super_fibonacci_rotations,
)
from deeplocalproteindocking_tpu.structure.transforms import apply_pose
from deeplocalproteindocking_tpu.sweep.docker import dock_sweep


class PoseSet(NamedTuple):
    """Ranked rigid-body poses of the (centered) ligand.

    ``scores`` always hold the docking score of the reported pose
    itself (comparable across dock/refine/rescore).  When a stage ranks
    by a different statistic (e.g. ``rescore(aggregate="topmean")``
    ranks by basin top-mean), that statistic lives in ``rank_scores``
    and the set is ordered by it; otherwise ``rank_scores`` is None
    (round-2 ADVICE: scores used to silently hold the ranking statistic
    under topmean).
    """
    scores: np.ndarray        # [K]
    rotations: np.ndarray     # [K, 3, 3]
    translations: np.ndarray  # [K, 3] Angstrom
    rot_idx: np.ndarray       # [K] into the rotation set
    shifts: np.ndarray        # [K, 3] voxel shifts
    rank_scores: Optional[np.ndarray] = None  # [K] ranking statistic

    def __len__(self):
        return len(self.scores)

    def ligand_coords(self, lig_coords: np.ndarray, i: int) -> np.ndarray:
        """Posed ligand coordinates (receptor frame) for pose ``i``."""
        return np.asarray(apply_pose(jnp.asarray(lig_coords),
                                     jnp.asarray(self.rotations[i]),
                                     jnp.asarray(self.translations[i])))


def shape_complementarity_reps(vol: jax.Array, *, core_weight: float = 12.0,
                               threshold: float = 0.35, shell: int = 2):
    """Analytic (surface, core) representation from a density volume.

    ``vol [L, L, L, T]`` -> rep ``[L, L, L, 2]`` and the fixed coupling
    ``[[1, 0], [0, -core_weight]]``: surface-surface contact attracts,
    core-core overlap repels — ZDOCK-style shape complementarity without
    a learned model.  (Implementation shared with the hybrid model's
    prior branch: models/representation.py:shape_channels.)
    """
    from deeplocalproteindocking_tpu.models.representation import (
        shape_channels)
    return shape_channels(vol, core_weight=core_weight,
                          threshold=threshold, shell=shell)


def dock_score_mask(cfg: DockConfig, lig_c: Structure,
                    translation_center=None, max_shift=None):
    """Translation mask for one complex (or None when unrestricted).

    Combines the circular-wraparound guard (poses whose shifted ligand
    leaves the box alias under circular correlation — SURVEY.md §7 hard
    part 3) with the optional local-docking restriction.  Shared by the
    sequential (pipeline.dock) and batched (evaluation) paths so both
    apply identical safety rails.
    """
    from deeplocalproteindocking_tpu.correlate.fft import translation_mask
    lig_half_vox = int(np.ceil(
        (np.abs(lig_c.typed().coords).max() + 3.0 * cfg.sigma)
        / cfg.resolution))
    wrap_cap = max(1, cfg.grid_size // 2 - lig_half_vox)
    score_mask = None
    if wrap_cap < cfg.grid_size // 2:
        score_mask = translation_mask(cfg.grid_size, wrap_cap)
    if max_shift is not None:
        center = (None if translation_center is None
                  else jnp.asarray(translation_center, jnp.int32))
        local = translation_mask(
            cfg.grid_size, int(round(max_shift / cfg.resolution)), center)
        score_mask = local if score_mask is None else score_mask & local
    return score_mask


def coupling_deviation_capture(coupling, rank: int, *,
                               shape_prior: bool = False,
                               core_weight: float = 12.0):
    """``(kept, dev)``: fraction of the LEARNED coupling deviation a
    rank-``rank`` SVD truncation keeps, and the deviation norm itself.

    The licensing criterion for ``DockConfig.coupling_rank`` is
    DEVIATION capture, not energy (DESIGN.md round-4): the hybrid
    model's coupling is dominated by the ±core_weight shape block
    (>99.99% of energy), but what training learned is the deviation
    ``A - prior`` — a truncation can keep all the energy while
    discarding most of the deviation.  Measured on v9p (held-out 48):
    rank 2 kept 99.992% energy but only ~29% of the deviation and
    collapsed global top-1 0.333 -> 0.167 (below the shape baseline);
    rank 3 kept ~96% and was hit-rate-identical to full rank.

    ``prior`` is ``diag(1, -core_weight)`` on the first two channels
    for the hybrid (models/representation.py:shape_channels) and
    identity for the plain model (models/scoring.py init).
    """
    A = np.asarray(coupling, np.float64)
    SB = np.zeros_like(A)
    if shape_prior:
        SB[0, 0] = 1.0
        if min(A.shape) > 1:
            SB[1, 1] = -core_weight
    else:
        np.fill_diagonal(SB, 1.0)
    U, s, Vt = np.linalg.svd(A)
    r = min(rank, len(s))
    Ar = (U[:, :r] * s[:r]) @ Vt[:r]
    dev = float(np.linalg.norm(A - SB))
    lost = float(np.linalg.norm(A - Ar))
    kept = 1.0 if dev <= 0 else 1.0 - lost / dev
    return kept, dev


def min_licensed_rank(coupling, *, shape_prior: bool = False,
                      core_weight: float = 12.0,
                      threshold: float = 0.95) -> int:
    """Smallest truncation rank keeping >= ``threshold`` of the
    learned coupling deviation (see coupling_deviation_capture)."""
    C = min(np.asarray(coupling).shape)
    for r in range(1, C + 1):
        kept, dev = coupling_deviation_capture(
            coupling, r, shape_prior=shape_prior,
            core_weight=core_weight)
        if dev <= 0 or kept >= threshold:
            return r
    return C


def ensemble_pair_batch(H_example: jax.Array,
                        budget_bytes: int = 512 * 1024 * 1024,
                        cap: int = 32) -> int:
    """Pair-batch size keeping dock_ensemble's STACKED receptor-side
    tensors within ``budget_bytes``.

    dock_ensemble stacks one receptor tensor per pair before each
    batched sweep (pipeline.dock_ensemble); at 128^3 / C=16 a complex64
    spectrum is ~136 MB per pair, so a fixed batch of 32 would stack
    >4 GB before the sweep's own activations — the per-device
    memory-amplification class of the rescore and batched-eval paths
    (DESIGN.md round-4).  The stacked spectra are read by every scan
    step, but each pair's sweep activations already scale with the
    pair batch (the in-scan chunk shrinks by the same factor), so a
    larger stack buys no throughput; 512 MB keeps it a small share of
    one device's memory and leaves the rest to the sweep.
    """
    per_pair = int(np.prod(H_example.shape)) * H_example.dtype.itemsize
    return max(1, min(cap, budget_bytes // max(per_pair, 1)))


@dataclasses.dataclass
class DockingPipeline:
    config: DockConfig
    params: Optional[dict] = None      # None => shape-complementarity mode
    mesh: Optional[object] = None      # jax Mesh => rotation-sharded sweep

    def __post_init__(self):
        self.model = ScoringModel(
            features=self.config.rep_features,
            kernel=self.config.rep_kernel,
            dtype=jnp.dtype(self.config.compute_dtype),
            shape_prior=self.config.shape_prior)
        # rep_fn closures are STATIC jit args of dock_sweep_resplat;
        # returning a fresh closure per dock() call forced a full
        # retrace per complex (the XLA compile was disk-cached, the
        # seconds of tracing were not).  Memoized per params object.
        self._closure_memo: dict = {}

    # ---- building blocks ----
    def init_params(self, seed: int = 0) -> dict:
        # Conv params are independent of spatial dims: init on a tiny
        # dummy.
        cfg = self.config
        dummy = jnp.zeros((16,) * 3 + (cfg.num_atom_types,))
        self.params = self.model.init(jax.random.key(seed), dummy,
                                      dummy)["params"]
        return self.params

    def voxelize(self, s: Structure, max_atoms: Optional[int] = None):
        # Matmul separable splat (atom-chunked on big grids); the
        # scatter-add variant (grids.voxelize.splat) is the test oracle.
        cfg = self.config
        coords, types, mask = structure_to_device(
            s, max_atoms, bucket=cfg.atom_bucket or None)
        return separable_splat(
            coords, types, mask, grid_size=cfg.grid_size,
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types,
            atom_chunk=4096 if len(coords) > 4096 else None)

    def representations(self, rec_vol: jax.Array, lig_vol: jax.Array):
        if self.params is None:
            rep_rec, coupling = shape_complementarity_reps(rec_vol)
            rep_lig, _ = shape_complementarity_reps(lig_vol)
            return rep_rec, rep_lig, coupling
        return self.model.apply({"params": self.params}, rec_vol, lig_vol)

    def rotation_set(self, native_rotation: Optional[jax.Array] = None):
        cfg = self.config
        if cfg.local_cone_deg is not None:
            base = (jnp.eye(3) if native_rotation is None
                    else native_rotation)
            return local_rotations(base, np.deg2rad(cfg.local_cone_deg),
                                   cfg.num_rotations)
        return super_fibonacci_rotations(cfg.num_rotations)

    def _ligand_rep_fn(self):
        """Batched density->representation closure for the resplat sweep."""
        if self.params is None:
            def rep_fn(vols):  # analytic shape channels, batched
                return jax.vmap(
                    lambda v: shape_complementarity_reps(v)[0])(vols)
            return rep_fn
        params = self.params
        model = self.model

        def rep_fn(vols):
            return model.apply({"params": params}, vols,
                               method=model.represent)
        return rep_fn

    def _spectral_parts(self, coupling):
        """(receptor-side coupling matrix, ligand rep_fn) for the
        spectral correlators, applying optional SVD rank truncation.

        The score is bilinear: ``S = sum_ec F[rep_rec]_e A[e,c]
        conj(F[rep_lig]_c)``.  With ``A = U diag(s) V^T`` truncated to
        rank r, the receptor side absorbs ``U_r diag(s_r)`` (a
        rectangular [C, r] receptor_transform) and the ligand reps
        project through ``V_r`` to r channels — per-rotation forward
        DFT + coupling FLOPs then scale with r instead of C, with score
        error bounded by the discarded singular values.  Exact when
        r >= rank(A) (the analytic shape coupling has rank 2).

        When the ligand CNN's LAST layer is linear (always true here —
        activations sit between convs only), ``V_r`` additionally folds
        INTO the final conv kernel, so the learned branch computes r
        output channels instead of C directly (round-3: conv2 was ~half
        the CNN cost at C2=14; folding makes it r-wide and deletes the
        projection einsum — pure XLA, no custom kernel).
        """
        # Memoized per (params, rank): ``coupling`` is always derived
        # from self.params (or the fixed shape-mode constant), and the
        # returned rep_fn closure must be IDENTITY-stable across calls
        # — it is a static jit arg downstream (see __post_init__).
        key = ("spectral", id(self.params), self.config.coupling_rank)
        if key in self._closure_memo:
            return self._closure_memo[key]
        out = self._spectral_parts_uncached(coupling)
        self._closure_memo[key] = out
        return out

    def _spectral_parts_uncached(self, coupling):
        rep_fn = self._ligand_rep_fn()
        r = self.config.coupling_rank
        if r is None or coupling is None or r >= min(coupling.shape):
            return coupling, rep_fn
        if self.params is not None:
            # Rank licensing is PER MODEL (round-4: energy said rank 2
            # was safe on v9p; hit rates said otherwise) — make the
            # license travel with the params instead of the docs.
            # Memoization in _spectral_parts means this runs once per
            # (params, rank), not per dock.
            kept, dev = coupling_deviation_capture(
                coupling, r, shape_prior=self.config.shape_prior)
            if dev > 1e-6 and kept < 0.95:
                import warnings
                lic = min_licensed_rank(
                    coupling, shape_prior=self.config.shape_prior)
                warnings.warn(
                    f"coupling_rank={r} keeps only {kept:.0%} of this "
                    f"model's learned coupling deviation (licensing "
                    f"criterion >=95%, DESIGN.md round-4; rank 2 on "
                    f"v9p collapsed global top-1 0.333->0.167). Use "
                    f"coupling_rank>={lic} or None.", stacklevel=3)
        U, s, Vt = np.linalg.svd(np.asarray(coupling, np.float32))
        proj_rec = jnp.asarray(U[:, :r] * s[None, :r])   # [C, r]
        proj_lig = jnp.asarray(Vt[:r].T)                 # [C, r]
        folded = self._folded_rep_fn(proj_lig)
        if folded is not None:
            return proj_rec, folded

        def rep_fn_r(vols):
            reps = rep_fn(vols)
            return jnp.einsum("...c,cr->...r", reps,
                              proj_lig.astype(reps.dtype),
                              precision=precision_for(reps.dtype))
        return proj_rec, rep_fn_r

    def _folded_rep_fn(self, proj_lig):
        """rep_fn computing ``represent(vols) @ proj_lig`` with the
        projection folded into the last (linear) conv layer; None when
        the model shape doesn't admit folding (shape mode)."""
        if self.params is None:
            return None
        cfg = self.config
        rep = self.params.get("representation", {})
        cnn = rep.get("cnn", rep) if cfg.shape_prior else rep
        try:
            convs = [cnn[f"conv{i}"]
                     for i in range(len(cfg.rep_features))]
            kernels = [c["kernel"] for c in convs]
            biases = [c.get("bias") for c in convs]
        except (KeyError, TypeError):
            return None
        if cfg.shape_prior:
            proj_prior = proj_lig[:2]                 # [2, r]
            proj_learned = proj_lig[2:]               # [C2, r]
        else:
            proj_prior = None
            proj_learned = proj_lig
        hi = precision_for()
        w_last = jnp.einsum("xyzio,or->xyzir", kernels[-1],
                            proj_learned, precision=hi)
        b_last = (None if biases[-1] is None
                  else jnp.matmul(biases[-1], proj_learned,
                                  precision=hi))      # [r]
        dt = jnp.dtype(cfg.compute_dtype)

        from deeplocalproteindocking_tpu.models.representation import (
            conv1_lowered, conv3d)

        def conv(i, x, w, b):
            # conv0 goes through the shared DLPD_CONV1 lowering helper,
            # so the knob holds on this path too.
            b = None if b is None else b.astype(dt)
            return (conv1_lowered if i == 0 else conv3d)(
                x, w.astype(dt), b)

        def rep_fn(vols):
            x = vols.astype(dt)
            for i, (w, b) in enumerate(zip(kernels[:-1], biases[:-1])):
                x = jax.nn.elu(conv(i, x, w, b))
            y = conv(len(kernels) - 1, x, w_last,
                     b_last).astype(jnp.float32)             # [..., r]
            if proj_prior is not None:
                from deeplocalproteindocking_tpu.models.representation \
                    import shape_channels
                prior = shape_channels(vols)[0]
                y = y + jnp.einsum("...c,cr->...r", prior,
                                   proj_prior.astype(prior.dtype),
                                   precision=hi)
            return y
        return rep_fn

    def _engine_parts(self, rep_rec, coupling):
        """``(impl, H, rep_fn)``: one correlator-engine dispatch shared
        by dock/rescore/batched eval (round-3 ADVICE: the dispatch
        lived only in dock(), so rescore/evaluate/mining crashed under
        ``fft_impl='block'``).

        ``impl`` is the resolved engine (the default dft falls back to
        the overlap-save block engine above 128^3); ``H`` is the
        receptor-side tensor that engine consumes (coupled rfft
        half-spectrum, or the real-space rep with coupling/rank
        projection folded in for 'block'); ``rep_fn`` maps ligand
        density volumes to the matching representation channels.
        """
        cfg = self.config
        impl = resolve_engine(cfg.fft_impl, cfg.grid_size)
        cpl_eff, rep_fn = self._spectral_parts(coupling)
        return impl, coupled_receptor(rep_rec, cpl_eff, impl), rep_fn

    def _batched_receptor_engine(self, coords, types, mask):
        """(impl, H_batch, rep_fn): the receptor half for a GROUP of
        complexes — splat + CNN + coupled spectrum batched over B in
        ONE compiled program.

        Round-3 VERDICT weak #4: ``run_benchmark_batched`` prepped
        receptors serially on host (per-complex voxelize + CNN
        dispatches ahead of the one-program sweep), which became the
        serial fraction at benchmark scale.  ``coords [B, A, 3]``,
        ``types [B, A]``, ``mask [B, A]`` padded device arrays.
        """
        cfg = self.config
        impl = resolve_engine(cfg.fft_impl, cfg.grid_size)
        if self.params is None:
            # Shape mode's coupling is the fixed analytic constant.
            coupling = shape_complementarity_reps(
                jnp.zeros((4, 4, 4, 1)))[1]
        else:
            coupling = self.params["coupling"]
        cpl_eff, rep_fn = self._spectral_parts(coupling)
        key = ("batched_engine", id(self.params), impl,
               cfg.coupling_rank)
        if key not in self._closure_memo:
            rep_half = self._ligand_rep_fn()   # batch-aware, unprojected

            @jax.jit
            def prep(coords, types, mask, cpl):
                chunk = 4096 if coords.shape[1] > 4096 else None
                vols = jax.vmap(lambda c, t, m: separable_splat(
                    c, t, m, grid_size=cfg.grid_size,
                    resolution=cfg.resolution, sigma=cfg.sigma,
                    num_types=cfg.num_atom_types,
                    atom_chunk=chunk))(coords, types, mask)
                reps = rep_half(vols)
                return jax.vmap(
                    lambda r: coupled_receptor(r, cpl, impl))(reps)

            self._closure_memo[key] = prep
        prep = self._closure_memo[key]
        # cpl_eff is never None here: both modes supply a real coupling
        # matrix (learned params or the analytic shape constant).
        return impl, prep(coords, types, mask, cpl_eff), rep_fn

    def _receptive_field(self) -> int:
        if self.params is None:
            return 3                      # shape mode: 2-voxel dilation + 1
        cfg = self.config
        rf = len(cfg.rep_features) * (cfg.rep_kernel // 2) + 1
        return max(rf, 3) if cfg.shape_prior else rf

    def _prepare(self, rec: Structure, lig: Structure):
        """Voxelize + represent both structures once (the CNN half of
        the stack); reusable across several sweeps of the same pair
        (``dock(prep=...)``) — e.g. the rescore stage's per-head cone
        sweeps."""
        rec_c = rec.centered()
        lig_c = lig.centered()
        if len(lig_c.typed()) == 0:
            raise ValueError(
                "no typed atoms in ligand: every atom fell outside the "
                "11-type table (all-HETATM/unknown-residue input?). "
                "Check chain selection and input format.")
        if len(rec_c.typed()) == 0:
            raise ValueError(
                "no typed atoms in receptor: every atom fell outside "
                "the 11-type table. Check chain selection and input "
                "format.")
        rec_vol = self.voxelize(rec_c)
        lig_vol = self.voxelize(lig_c)
        rep_rec, rep_lig, coupling = self.representations(rec_vol,
                                                          lig_vol)
        return rec_c, lig_c, rep_rec, rep_lig, coupling

    # ---- the full stack (SURVEY.md §3.1) ----
    def dock(self, rec: Structure, lig: Structure,
             rotations: Optional[jax.Array] = None,
             cluster: bool = True,
             translation_center: Optional[np.ndarray] = None,
             max_shift: Optional[float] = None,
             prep=None, engine=None) -> PoseSet:
        """Dock centered structures; returns ranked (clustered) poses.

        Local docking (the reference's headline mode): pass a rotation
        set from ``rotation_set(native_R)`` plus ``translation_center``
        (signed voxel shift of the native pose) and ``max_shift``
        (Angstrom) to restrict the translational search around it.

        ``engine`` is an optional precomputed ``_engine_parts`` tuple —
        the receptor-side half of the correlator (including the
        receptor FFT), cacheable across queries of the same receptor
        (serving.DockingService, dock_ensemble).
        """
        cfg = self.config
        if prep is None:
            prep = self._prepare(rec, lig)
        rec_c, lig_c, rep_rec, rep_lig, coupling = prep
        if rotations is None:
            rotations = self.rotation_set()
        score_mask = dock_score_mask(cfg, lig_c, translation_center,
                                     max_shift)
        if cfg.sweep_mode == "resplat":
            from deeplocalproteindocking_tpu.sweep.resplat import (
                auto_ligand_grid, dock_sweep_resplat)
            if engine is None:
                engine = self._engine_parts(rep_rec, coupling)
            impl, H, rep_fn = engine
            lc, lt, lm = structure_to_device(
                lig_c, bucket=cfg.atom_bucket or None)
            lig_grid = cfg.lig_grid_size or auto_ligand_grid(
                lig_c.typed().coords, cfg.resolution, cfg.sigma,
                self._receptive_field(), cfg.grid_size)
            kw = dict(grid_size=cfg.grid_size, lig_grid=lig_grid,
                      resolution=cfg.resolution, sigma=cfg.sigma,
                      num_types=cfg.num_atom_types, top_k=cfg.top_k,
                      chunk=cfg.rotation_chunk, score_mask=score_mask,
                      fft_impl=impl, dft_dtype=cfg.dft_dtype,
                      topk_impl=cfg.topk_impl, fft_block=cfg.fft_block)
            if self.mesh is not None:
                from deeplocalproteindocking_tpu.parallel.sharded_sweep \
                    import sharded_dock_sweep_resplat
                res = sharded_dock_sweep_resplat(
                    self.mesh, H, lc, lt, lm, rotations,
                    rep_fn, **kw)
            else:
                res = dock_sweep_resplat(H, lc, lt, lm, rotations,
                                         rep_fn, **kw)
        elif self.mesh is not None:
            res = sharded_dock_sweep(
                self.mesh, rep_rec, rep_lig, rotations, coupling,
                top_k=cfg.top_k, chunk=cfg.rotation_chunk,
                score_mask=score_mask)
        else:
            res = dock_sweep(rep_rec, rep_lig,
                             rotations, coupling,
                             top_k=cfg.top_k, chunk=cfg.rotation_chunk,
                             score_mask=score_mask)
        scores = np.asarray(res.scores)
        rot_idx = np.asarray(res.rot_idx)
        shifts = np.asarray(res.shifts)
        Rs = np.asarray(rotations)[rot_idx]
        ts = shifts.astype(np.float32) * cfg.resolution

        poses = PoseSet(scores=scores, rotations=Rs, translations=ts,
                        rot_idx=rot_idx, shifts=shifts)
        if cluster:
            from deeplocalproteindocking_tpu.sweep.cluster import (
                cluster_pose_set)
            poses = cluster_pose_set(lig_c.coords, poses, cfg.nms_rmsd)
        return poses

    def dock_complex(self, cplx: Complex, **kw) -> PoseSet:
        return self.dock(cplx.receptor, cplx.ligand, **kw)

    def _receptor_half(self, rec: Structure):
        """Centered structure + representation + coupling for a
        receptor ALONE — the CNN applies per-structure and the coupling
        comes from the params, so no ligand is needed.  Shared by the
        serving cache and ensemble docking, which both amortize this
        half across many ligand-side queries."""
        rec_c = rec.centered()
        if len(rec_c.typed()) == 0:
            raise ValueError(
                "no typed atoms in receptor: every atom fell outside "
                "the 11-type table. Check chain selection and input "
                "format.")
        rec_vol = self.voxelize(rec_c)
        if self.params is None:
            rep_rec, coupling = shape_complementarity_reps(rec_vol)
        else:
            rep_rec = self.model.apply({"params": self.params}, rec_vol,
                                       method=self.model.represent)
            coupling = self.params["coupling"]
        return rec_c, rep_rec, coupling

    def dock_ensemble(self, rec_models: list, lig_models: list,
                      pairing: str = "product", cluster: bool = True,
                      **kw):
        """NMR-ensemble docking: dock model pairs, merge one ranked set.

        The reference docks single conformers; multi-model (NMR) files
        carry conformational uncertainty that rigid docking can exploit
        by sweeping every model pair and ranking the union.  ``pairing``
        is ``"product"`` (every receptor model x every ligand model) or
        ``"zip"`` (model i with model i — matched-ensemble inputs).

        Returns ``(poses, pairs)``: a merged score-ranked ``PoseSet``
        plus an int ``[K, 2]`` array of (receptor_model, ligand_model)
        0-based indices per pose.  Cross-model NMS uses the first
        ligand model's coords as the cluster representative — NMR
        ensembles share one deposition frame, so pose proximity across
        models is meaningful at cluster-radius (~5 A) precision.

        Each receptor model is voxelized + represented + FFT'd ONCE and
        each ligand model device-padded ONCE (R + L preps, not R x L);
        pairs then sweep as a batch axis of one compiled program
        (``parallel.batch_eval.dock_batch``) in chunks of
        ``pair_batch`` (bounds the stacked receptor-spectrum memory:
        R=L=20 product ensembles are 400 pairs).  Round-3 VERDICT
        missing #5: the per-pair ``self.dock`` loop recomputed the
        receptor half L times per model and dispatched R x L separate
        programs.
        """
        import itertools
        if pairing == "product":
            pair_list = list(itertools.product(range(len(rec_models)),
                                               range(len(lig_models))))
        elif pairing == "zip":
            if len(rec_models) != len(lig_models):
                raise ValueError(
                    f"pairing='zip' needs equal model counts, got "
                    f"{len(rec_models)} receptor vs {len(lig_models)} "
                    f"ligand models")
            pair_list = [(i, i) for i in range(len(rec_models))]
        else:
            raise ValueError(f"unknown pairing {pairing!r} "
                             "(want 'product' or 'zip')")
        if not pair_list:
            raise ValueError("empty model ensemble")

        cfg = self.config
        rotations = kw.pop("rotations", None)
        translation_center = kw.pop("translation_center", None)
        max_shift = kw.pop("max_shift", None)
        pair_batch = kw.pop("pair_batch", None)
        if kw:
            raise TypeError(f"dock_ensemble: unexpected kwargs {list(kw)}")
        if rotations is None:
            rotations = self.rotation_set()

        if cfg.sweep_mode != "resplat":
            # Legacy resample engine has no batched pair program; the
            # per-pair loop is kept for it (it is off the hot path).
            return self._dock_ensemble_sequential(
                rec_models, lig_models, pair_list, cluster,
                rotations=rotations,
                translation_center=translation_center,
                max_shift=max_shift)

        from deeplocalproteindocking_tpu.parallel.batch_eval import (
            dock_batch)
        from deeplocalproteindocking_tpu.sweep.resplat import (
            auto_ligand_grid)

        # R receptor halves (voxelize + CNN + coupled FFT), once each.
        engines = [self._engine_parts(rep, cpl) for _, rep, cpl in
                   (self._receptor_half(r) for r in rec_models)]
        impl, H0, rep_fn = engines[0]
        if pair_batch is None:
            pair_batch = ensemble_pair_batch(H0)

        # L ligand halves: centered + device-padded to a common atom
        # count, plus per-model translation rails, once each.
        lig_cs = []
        for l in lig_models:
            lc_ = l.centered()
            if len(lc_.typed()) == 0:
                raise ValueError(
                    "no typed atoms in ligand: every atom fell outside "
                    "the 11-type table. Check chain selection and "
                    "input format.")
            lig_cs.append(lc_)
        max_atoms = max(len(l.typed()) for l in lig_cs)
        if cfg.atom_bucket:
            b = cfg.atom_bucket
            max_atoms = max(b, ((max_atoms + b - 1) // b) * b)
        lig_dev = [structure_to_device(l, max_atoms) for l in lig_cs]
        rf = self._receptive_field()
        lig_grid = cfg.lig_grid_size or max(
            auto_ligand_grid(l.typed().coords, cfg.resolution,
                             cfg.sigma, rf, cfg.grid_size)
            for l in lig_cs)
        masks = [dock_score_mask(cfg, l, translation_center, max_shift)
                 for l in lig_cs]
        any_mask = any(m is not None for m in masks)
        if any_mask:
            ones = jnp.ones((cfg.grid_size,) * 3, dtype=bool)
            masks = [ones if m is None else m for m in masks]

        # The pair axis multiplies every per-scan-step activation by
        # the per-device batch, exactly like the complex axis in
        # batched evaluation — shrink the in-scan rotation chunk by
        # the same factor, as rescore and batched evaluation do.
        kwb = dict(grid_size=cfg.grid_size, lig_grid=lig_grid,
                   resolution=cfg.resolution, sigma=cfg.sigma,
                   num_types=cfg.num_atom_types, top_k=cfg.top_k,
                   fft_impl=impl,
                   dft_dtype=cfg.dft_dtype, fft_block=cfg.fft_block)
        all_scores, all_rot, all_shift, tags = [], [], [], []
        for start in range(0, len(pair_list), pair_batch):
            chunk_pairs = pair_list[start:start + pair_batch]
            H = jnp.stack([engines[ri][1] for ri, _ in chunk_pairs])
            lc = jnp.stack([lig_dev[li][0] for _, li in chunk_pairs])
            lt = jnp.stack([lig_dev[li][1] for _, li in chunk_pairs])
            lm = jnp.stack([lig_dev[li][2] for _, li in chunk_pairs])
            sm = (jnp.stack([masks[li] for _, li in chunk_pairs])
                  if any_mask else None)
            B = len(chunk_pairs)
            mesh = self.mesh
            if mesh is not None and not (
                    set(mesh.shape) >= {"batch", "rot"}
                    and B % mesh.shape["batch"] == 0):
                mesh = None    # dock()'s rot-only mesh: vmap instead
            # Per-DEVICE pair count decides the chunk scale, and it
            # depends on whether THIS batch actually sharded: the
            # vmap fallback above puts all B pairs on every device, so
            # scaling by B/mesh_batch there would re-open the
            # per-device memory-amplification crash class the scaling
            # exists to close.
            per_dev = (B if mesh is None
                       else -(-B // mesh.shape["batch"]))
            kwb["chunk"] = max(1, cfg.rotation_chunk
                               // max(per_dev, 1))
            res = dock_batch(mesh, H, lc, lt, lm, rotations, rep_fn,
                             score_mask=sm, **kwb)
            all_scores.append(np.asarray(res.scores).reshape(-1))
            all_rot.append(np.asarray(res.rot_idx).reshape(-1))
            all_shift.append(np.asarray(res.shifts).reshape(-1, 3))
            k = res.scores.shape[1]
            for ri, li in chunk_pairs:
                tags.extend([(ri, li)] * k)

        scores = np.concatenate(all_scores)
        rot_idx = np.concatenate(all_rot)
        shifts = np.concatenate(all_shift)
        rot_np = np.asarray(rotations)
        order = np.argsort(-scores, kind="stable")
        merged = PoseSet(
            scores=scores[order],
            rotations=rot_np[rot_idx[order]],
            translations=(shifts[order].astype(np.float32)
                          * cfg.resolution),
            rot_idx=rot_idx[order],
            shifts=shifts[order])
        pairs = np.asarray(tags, dtype=np.int64)[order]
        return self._merge_ensemble(merged, pairs, lig_models, cluster)

    def _merge_ensemble(self, merged: "PoseSet", pairs: np.ndarray,
                        lig_models: list, cluster: bool):
        if cluster and len(merged) > 1:
            from deeplocalproteindocking_tpu.sweep.cluster import (
                nms_cluster, pose_pairwise_rmsd)
            rep = lig_models[0].centered().coords
            D = pose_pairwise_rmsd(jnp.asarray(rep),
                                   jnp.asarray(merged.rotations),
                                   jnp.asarray(merged.translations))
            keep = nms_cluster(merged.scores, D, self.config.nms_rmsd,
                               max_out=self.config.top_k)
            merged = PoseSet(*(np.asarray(f)[keep] for f in merged[:5]))
            pairs = pairs[keep]
        return merged, pairs

    def _dock_ensemble_sequential(self, rec_models, lig_models,
                                  pair_list, cluster, **kw):
        parts, tags = [], []
        for ri, li in pair_list:
            # Per-pair clustering is skipped: NMS once, on the union.
            poses = self.dock(rec_models[ri], lig_models[li],
                              cluster=False, **kw)
            parts.append(poses)
            tags.extend([(ri, li)] * len(poses))

        def cat(field):
            return np.concatenate([getattr(p, field) for p in parts])

        scores = cat("scores")
        order = np.argsort(-scores, kind="stable")
        merged = PoseSet(scores=scores[order],
                         rotations=cat("rotations")[order],
                         translations=cat("translations")[order],
                         rot_idx=cat("rot_idx")[order],
                         shifts=cat("shifts")[order])
        pairs = np.asarray(tags, dtype=np.int64)[order]
        return self._merge_ensemble(merged, pairs, lig_models, cluster)

    # ---- hierarchical focused rescoring ----
    def rescore(self, rec: Structure, lig: Structure, poses: PoseSet,
                top: int = 16, nrot: int = 48,
                cone_deg: float = 15.0, shift_vox: int = 3,
                aggregate: str = "max", agg_top: int = 8,
                prep=None, engine=None) -> PoseSet:
        """Re-rank top cluster heads by a dense local cone sweep each.

        A coarse global rotation set (covering radius ~10-15 deg at
        ~1.5k rotations) undersamples every pose's rotational basin, so
        coarse scores are noisy LOWER bounds on each basin's true max —
        and ranking by noisy lower bounds costs top-1 hits.  For each
        of the ``top`` heads this sweeps ``nrot`` rotations in a
        ``cone_deg`` cone around the head's rotation with translations
        confined to ``+-shift_vox`` voxels of its shift, then re-ranks
        heads by their recovered basin maxima.  The reference reaches
        the same effect offline by re-docking candidates locally
        [U: DeepLocalProteinDocking local protocol]; here it is one
        pipeline stage.

        ALL head cone sweeps run as ONE compiled program (heads are a
        vmap batch axis over per-head rotation sets and translation
        masks) — the round-2 host loop cost 16 sequential device
        dispatches per complex and barred the batched-eval path from
        the two-stage configuration (round-2 VERDICT #2).

        ``aggregate="topmean"`` ranks heads by the mean of their best
        ``agg_top`` scores within the cone instead of the single max —
        a funnel-width signal (native basins are wide, impostor spikes
        are narrow; cf. cluster-size confidence in classic FFT
        docking).  The reported pose is the basin argmax either way;
        ``scores`` hold the argmax score and ``rank_scores`` the
        ranking statistic.

        Poses beyond ``top`` are appended unrescored (coarse scores)
        so the returned set never shrinks (round-2 ADVICE).
        """
        from deeplocalproteindocking_tpu.correlate.fft import (
            translation_mask)
        from deeplocalproteindocking_tpu.sweep.resplat import (
            auto_ligand_grid, dock_sweep_resplat)
        cfg = self.config
        n = min(top, len(poses))
        if n == 0:
            return poses
        if prep is None:
            prep = self._prepare(rec, lig)
        rec_c, lig_c, rep_rec, rep_lig, coupling = prep
        if engine is None:
            engine = self._engine_parts(rep_rec, coupling)
        impl, H, rep_fn = engine
        lc, lt, lm = structure_to_device(
            lig_c, bucket=cfg.atom_bucket or None)
        lig_grid = cfg.lig_grid_size or auto_ligand_grid(
            lig_c.typed().coords, cfg.resolution, cfg.sigma,
            self._receptive_field(), cfg.grid_size)
        # Per-head cone rotation sets; the head itself stays at index 0
        # so the rescored score is >= the coarse score by construction.
        head_rots = []
        for i in range(n):
            base = jnp.asarray(poses.rotations[i])
            cone = local_rotations(base, np.deg2rad(cone_deg), nrot)
            head_rots.append(
                jnp.concatenate([base[None], cone[:-1]], axis=0))
        head_rots = jnp.stack(head_rots)          # [n, nrot, 3, 3]
        # Per-head masks: +-shift_vox window AND the shared
        # circular-wraparound guard (same rails as pipeline.dock).
        guard = dock_score_mask(cfg, lig_c)
        masks = []
        for i in range(n):
            m = translation_mask(
                cfg.grid_size, int(shift_vox),
                jnp.asarray(poses.shifts[i], jnp.int32))
            masks.append(m if guard is None else m & guard)
        head_masks = jnp.stack(masks)             # [n, L, L, L]
        K = max(agg_top if aggregate == "topmean" else 1, 1)
        # The head axis multiplies every per-scan-step activation
        # (splat volumes, CNN features, score volumes) by n, so the
        # in-scan rotation chunk must shrink by the same factor:
        # rotation_chunk is sized as the per-step rotation batch for
        # ONE sweep, and n heads x chunk 64 at grid 64 is multiple GB
        # of activations per step.
        chunk = max(1, min(cfg.rotation_chunk, nrot) // max(n, 1))
        kw = dict(grid_size=cfg.grid_size, lig_grid=lig_grid,
                  resolution=cfg.resolution, sigma=cfg.sigma,
                  num_types=cfg.num_atom_types, top_k=K,
                  chunk=chunk,
                  fft_impl=impl, dft_dtype=cfg.dft_dtype,
                  topk_impl=cfg.topk_impl, fft_block=cfg.fft_block)
        res = jax.vmap(
            lambda rots, sm: dock_sweep_resplat(
                H, lc, lt, lm, rots, rep_fn, score_mask=sm, **kw)
        )(head_rots, head_masks)
        scores = np.asarray(res.scores)           # [n, K]
        rot_idx = np.asarray(res.rot_idx)         # [n, K]
        shifts = np.asarray(res.shifts)           # [n, K, 3]
        best = scores[:, 0]
        rank = (scores[:, :agg_top].mean(axis=1)
                if aggregate == "topmean" else best)
        hr = np.asarray(head_rots)
        Rs = hr[np.arange(n), rot_idx[:, 0]]
        ts = shifts[:, 0].astype(np.float32) * cfg.resolution
        order = np.argsort(-rank)
        # Unrescored tail keeps its coarse scores (comparable scale:
        # same scoring function, sparser search).  With
        # aggregate="max" every rescored head score is >= its coarse
        # score, which was >= every tail score, so heads-before-tail
        # already preserves the ranking; with "topmean" a head's basin
        # top-mean CAN fall below a tail pose's coarse score, so the
        # combined set is re-sorted jointly on rank_scores (round-3
        # ADVICE: the ordering invariant only held for "max").
        tail = slice(n, len(poses))
        out = PoseSet(
            scores=np.concatenate([best[order],
                                   poses.scores[tail]]).astype(
                                       np.float32),
            rotations=np.concatenate([Rs[order],
                                      poses.rotations[tail]]),
            translations=np.concatenate([ts[order],
                                         poses.translations[tail]]),
            rot_idx=np.concatenate([np.full(n, -1, np.int32),
                                    poses.rot_idx[tail]]),
            shifts=np.concatenate([shifts[order, 0],
                                   poses.shifts[tail]]),
            rank_scores=np.concatenate([rank[order],
                                        poses.scores[tail]]).astype(
                                            np.float32),
        )
        if aggregate == "topmean" and len(poses) > n:
            joint = np.argsort(-out.rank_scores, kind="stable")
            out = PoseSet(*(np.asarray(f)[joint] for f in out[:5]),
                          rank_scores=out.rank_scores[joint])
        return out

    # ---- continuous refinement (sweep/refine.py; no reference analog) ----
    def refine(self, rec: Structure, lig: Structure, poses: PoseSet,
               steps: int = 30, lr: float = 0.02,
               prep=None, engine=None) -> PoseSet:
        """Polish poses by gradient ascent in continuous pose space.

        Returns a re-ranked PoseSet with continuous translations
        (shifts hold the nearest lattice point for bookkeeping).

        Shares the ``_engine_parts`` dispatch with every other consumer
        (round-4 VERDICT weak #3: refine built its own full-rank
        ``receptor_transform`` — ``coupling_rank`` was silently ignored
        and ``fft_impl='block'`` would have materialized exactly the
        full spectrum the block engine exists to avoid).  Under
        ``'block'`` the continuous score runs spectrum-free in real
        space (sweep/refine.py:continuous_score_block).
        """
        from deeplocalproteindocking_tpu.sweep.refine import refine_poses
        from deeplocalproteindocking_tpu.sweep.resplat import (
            auto_ligand_grid)
        cfg = self.config
        if prep is None:
            prep = self._prepare(rec, lig)
        rec_c, lig_c, rep_rec, rep_lig, coupling = prep
        if engine is None:
            engine = self._engine_parts(rep_rec, coupling)
        impl, H, rep_fn = engine
        lc, lt, lm = structure_to_device(
                lig_c, bucket=cfg.atom_bucket or None)
        lig_grid = cfg.lig_grid_size or auto_ligand_grid(
            lig_c.typed().coords, cfg.resolution, cfg.sigma,
            self._receptive_field(), cfg.grid_size)
        if impl not in ("block",):
            # Spectral engines share one complex-H continuous score;
            # refine consumes H as a complex array (re/im attributes).
            H = H if jnp.iscomplexobj(H) else H.astype(jnp.complex64)
        out = refine_poses(
            H, lc, lt, lm, jnp.asarray(poses.rotations),
            jnp.asarray(poses.shifts), rep_fn,
            grid_size=cfg.grid_size, lig_grid=lig_grid,
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types, steps=steps, lr=lr,
            fft_impl=impl)
        order = np.argsort(-np.asarray(out.scores))
        return PoseSet(
            scores=np.asarray(out.scores)[order],
            rotations=np.asarray(out.rotations)[order],
            translations=np.asarray(out.translations)[order],
            rot_idx=poses.rot_idx[order],
            shifts=np.round(np.asarray(out.translations)[order]
                            / cfg.resolution).astype(np.int32),
        )
