"""11-type chemical atom classification for protein heavy atoms.

Re-implements the capability of the reference's ``Coords2TypedCoords``
[U: TorchProteinLibrary/Layers/FullAtomModel/Coords2TypedCoords — mount
empty, unverified; scheme follows Derevyanko & Lamoureux, bioRxiv 738690]:
every heavy atom of the 20 standard residues maps to one of 11 chemical
types (carbon sp3 / sp2 / aromatic; nitrogen amide / aromatic /
guanidinium / ammonium; oxygen carbonyl / carboxyl / hydroxyl; sulfur).

Divergence from the reference: the reference physically *reorders*
coordinates grouped by type and returns per-type offset/count tensors
(its CUDA splat kernel iterated contiguous type ranges).  Here the
voxelizer indexes its type channel by a per-atom integer type, so no
reordering is needed — this module just returns ``types[N] int32`` with
``-1`` for atoms outside the table (dropped downstream).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

NUM_ATOM_TYPES = 11

C_SP3, C_SP2, C_ARO, N_AMIDE, N_ARO, N_GUA, N_AMMO, O_CARBONYL, O_CARBOXYL, O_HYDROXYL, SULFUR = range(11)

ATOM_TYPE_NAMES = (
    "C_sp3", "C_sp2", "C_aromatic",
    "N_amide", "N_aromatic", "N_guanidinium", "N_ammonium",
    "O_carbonyl", "O_carboxyl", "O_hydroxyl",
    "S",
)

# Backbone atoms shared by every residue.
_BACKBONE = {
    "N": N_AMIDE,
    "CA": C_SP3,
    "C": C_SP2,        # carbonyl carbon
    "O": O_CARBONYL,
    "OXT": O_CARBOXYL,  # C-terminal carboxylate
}

# Side-chain atoms per residue (heavy atoms only, PDB v3 naming).
_SIDECHAIN = {
    "ALA": {"CB": C_SP3},
    "ARG": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP3,
            "NE": N_GUA, "CZ": C_SP2, "NH1": N_GUA, "NH2": N_GUA},
    "ASN": {"CB": C_SP3, "CG": C_SP2, "OD1": O_CARBONYL, "ND2": N_AMIDE},
    "ASP": {"CB": C_SP3, "CG": C_SP2, "OD1": O_CARBOXYL, "OD2": O_CARBOXYL},
    "CYS": {"CB": C_SP3, "SG": SULFUR},
    "GLN": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP2,
            "OE1": O_CARBONYL, "NE2": N_AMIDE},
    "GLU": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP2,
            "OE1": O_CARBOXYL, "OE2": O_CARBOXYL},
    "GLY": {},
    "HIS": {"CB": C_SP3, "CG": C_ARO, "ND1": N_ARO, "CD2": C_ARO,
            "CE1": C_ARO, "NE2": N_ARO},
    "ILE": {"CB": C_SP3, "CG1": C_SP3, "CG2": C_SP3, "CD1": C_SP3},
    "LEU": {"CB": C_SP3, "CG": C_SP3, "CD1": C_SP3, "CD2": C_SP3},
    "LYS": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP3, "CE": C_SP3,
            "NZ": N_AMMO},
    "MET": {"CB": C_SP3, "CG": C_SP3, "SD": SULFUR, "CE": C_SP3},
    "PHE": {"CB": C_SP3, "CG": C_ARO, "CD1": C_ARO, "CD2": C_ARO,
            "CE1": C_ARO, "CE2": C_ARO, "CZ": C_ARO},
    "PRO": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP3},
    "SER": {"CB": C_SP3, "OG": O_HYDROXYL},
    "THR": {"CB": C_SP3, "OG1": O_HYDROXYL, "CG2": C_SP3},
    "TRP": {"CB": C_SP3, "CG": C_ARO, "CD1": C_ARO, "CD2": C_ARO,
            "NE1": N_ARO, "CE2": C_ARO, "CE3": C_ARO, "CZ2": C_ARO,
            "CZ3": C_ARO, "CH2": C_ARO},
    "TYR": {"CB": C_SP3, "CG": C_ARO, "CD1": C_ARO, "CD2": C_ARO,
            "CE1": C_ARO, "CE2": C_ARO, "CZ": C_ARO, "OH": O_HYDROXYL},
    "VAL": {"CB": C_SP3, "CG1": C_SP3, "CG2": C_SP3},
}

# Common alternate residue names mapped onto the standard 20.
_RES_ALIASES = {
    "MSE": "MET",  # selenomethionine; SE treated as SD below
    "HSD": "HIS", "HSE": "HIS", "HSP": "HIS", "HID": "HIS", "HIE": "HIS",
    "CYX": "CYS", "CYM": "CYS",
    "ASH": "ASP", "GLH": "GLU", "LYN": "LYS", "ARN": "ARG",
}

# Flattened lookup: (res, atom) -> type.
_TABLE = {}
for _res, _atoms in _SIDECHAIN.items():
    for _an, _ty in _BACKBONE.items():
        _TABLE[(_res, _an)] = _ty
    for _an, _ty in _atoms.items():
        _TABLE[(_res, _an)] = _ty
_TABLE[("MET", "SE")] = SULFUR  # MSE selenium


def assign_atom_types(res_names: Sequence[str],
                      atom_names: Sequence[str]) -> np.ndarray:
    """Map (residue name, atom name) pairs to the 11-type table.

    Returns ``int32[N]`` with ``-1`` for hydrogens, waters, hetero atoms
    and anything else outside the table; callers drop those atoms.
    """
    out = np.full(len(res_names), -1, dtype=np.int32)
    for i, (res, atom) in enumerate(zip(res_names, atom_names)):
        res = _RES_ALIASES.get(res, res)
        out[i] = _TABLE.get((res, atom), -1)
    return out


def type_histogram(types: np.ndarray) -> np.ndarray:
    """Count of atoms per type (ignores -1)."""
    t = types[types >= 0]
    return np.bincount(t, minlength=NUM_ATOM_TYPES)
