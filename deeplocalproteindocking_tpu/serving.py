"""Persistent docking service: receptor-spectrum cache + batched queries.

Serving shape for production deployment (round-2 ROADMAP #5 / VERDICT
next-round #10): in screening workloads one receptor is docked against
many ligands, but ``pipeline.dock`` recomputes the receptor half of the
stack — voxelize, CNN representation, coupled FFT spectrum — on every
call.  ``DockingService`` computes that half ONCE per receptor and
caches the full engine tuple — the resolved correlator, the coupled
receptor tensor ``H`` (rfft half-spectrum, or the coupling-folded
real-space rep for the block engine), and the ligand rep_fn — keyed by
a structure hash, so repeat queries pay only the ligand-side work
(per-rotation splat + CNN + correlation).

The reference has no serving layer at all (single-GPU research scripts,
SURVEY.md §1); this is a new capability on top of
``pipeline._prepare``/``dock(prep=)``.

Cache key = SHA-256 over (receptor coords/types bytes, the scoring
geometry fields of the config, a params fingerprint) — anything that
changes the receptor representation changes the key.  Entries are
LRU-bounded on the HOST; device buffers free when evicted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeplocalproteindocking_tpu.config import DockConfig
from deeplocalproteindocking_tpu.pipeline import (
    DockingPipeline, PoseSet, shape_complementarity_reps,
)
from deeplocalproteindocking_tpu.structure.pdb import Structure

# Config fields that change receptor-side scoring semantics (grid
# geometry + model). Sweep-control knobs (rotations, top_k, chunk...)
# deliberately excluded: they reuse the same spectrum.
_GEOM_FIELDS = ("grid_size", "resolution", "sigma", "num_atom_types",
                "rep_features", "rep_kernel", "shape_prior",
                "compute_dtype")


@dataclasses.dataclass
class _Entry:
    rec_c: Structure
    rep_rec: jax.Array
    coupling: Optional[jax.Array]
    engine: tuple   # (impl, H, rep_fn) — pipeline._engine_parts


class DockingService:
    """One receptor prepared once, many ligand queries.

    >>> svc = DockingService(cfg, params)
    >>> svc.dock(rec, lig1); svc.dock(rec, lig2)   # receptor CNN+FFT
    ...                                            # runs once
    """

    def __init__(self, config: DockConfig, params: Optional[dict] = None,
                 mesh=None, capacity: int = 8):
        self.pipeline = DockingPipeline(config=config, params=params,
                                        mesh=mesh)
        self.capacity = capacity
        self._cache: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    # ---- keys ----
    def _params_fingerprint(self) -> str:
        p = self.pipeline.params
        if p is None:
            return "shape"
        leaves = jax.tree_util.tree_leaves(p)
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.asarray(leaf).tobytes())
        return h.hexdigest()[:16]

    def receptor_key(self, rec: Structure) -> str:
        cfg = self.pipeline.config
        h = hashlib.sha256()
        t = rec.typed()
        h.update(np.ascontiguousarray(t.coords).tobytes())
        h.update(np.ascontiguousarray(t.types).tobytes())
        h.update(json.dumps([getattr(cfg, f) for f in _GEOM_FIELDS],
                            default=str).encode())
        h.update(self._params_fingerprint().encode())
        return h.hexdigest()

    # ---- the cached receptor half ----
    def prepare_receptor(self, rec: Structure) -> str:
        """Voxelize + represent the receptor; returns the cache key."""
        key = self.receptor_key(rec)
        if key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return key
        self.misses += 1
        pipe = self.pipeline
        rec_c, rep_rec, coupling = pipe._receptor_half(rec)
        self._cache[key] = _Entry(rec_c=rec_c, rep_rec=rep_rec,
                                  coupling=coupling,
                                  engine=pipe._engine_parts(rep_rec,
                                                            coupling))
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)       # LRU eviction
        return key

    def _ligand_half(self, lig: Structure):
        pipe = self.pipeline
        lig_c = lig.centered()
        if len(lig_c.typed()) == 0:
            raise ValueError("no typed atoms in ligand")
        lig_vol = pipe.voxelize(lig_c)
        if pipe.params is None:
            rep_lig, _ = shape_complementarity_reps(lig_vol)
        else:
            rep_lig = pipe.model.apply({"params": pipe.params}, lig_vol,
                                       method=pipe.model.represent)
        return lig_c, rep_lig

    # ---- queries ----
    def dock(self, rec: Structure, lig: Structure, **kw) -> PoseSet:
        """pipeline.dock with the receptor half served from cache."""
        key = self.prepare_receptor(rec)
        e = self._cache[key]
        lig_c, rep_lig = self._ligand_half(lig)
        prep = (e.rec_c, lig_c, e.rep_rec, rep_lig, e.coupling)
        return self.pipeline.dock(rec, lig, prep=prep, engine=e.engine,
                                  **kw)

    def rescore(self, rec: Structure, lig: Structure, poses: PoseSet,
                **kw) -> PoseSet:
        """pipeline.rescore with the cached receptor half."""
        key = self.prepare_receptor(rec)
        e = self._cache[key]
        lig_c, rep_lig = self._ligand_half(lig)
        prep = (e.rec_c, lig_c, e.rep_rec, rep_lig, e.coupling)
        return self.pipeline.rescore(rec, lig, poses, prep=prep,
                                     engine=e.engine, **kw)

    @property
    def stats(self) -> dict:
        return dict(entries=len(self._cache), hits=self.hits,
                    misses=self.misses)
