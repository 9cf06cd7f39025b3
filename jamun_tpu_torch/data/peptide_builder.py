"""Heavy-atom peptide structures from a sequence (the port's own numpy copy of
`jamun_tpu/data/peptide_builder.py`).

Atoms are placed by NeRF (natural extension reference frame) from idealized
internal coordinates: extended backbone (phi -135, psi 135), standard bond
lengths and angles, side chains at their default dihedrals. The geometry is
idealized, not energy-minimized: starting structures for sampling, and
synthetic datasets.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from jamun_tpu_torch.data.residue_metadata import convert_to_three_letter_codes
from jamun_tpu_torch.data.topology import Atom, Topology, infer_bonds

__all__ = ["build_peptide", "SIDE_CHAINS"]

# bond lengths (nm)
_B = {"CC": 0.1526, "CN": 0.1329, "CaN": 0.1458, "CO": 0.1231, "COH": 0.1410,
      "CS": 0.1810, "CNsc": 0.1470, "CCar": 0.1390}
_TET = 109.5
_SP2 = 120.0

# Side-chain heavy atoms: name -> (parent, grandparent, ggparent, bond, angle, dihedral)
# Reference frame atoms are names within the same residue ("-C" = previous C).
SIDE_CHAINS: Dict[str, List[Tuple[str, str, str, str, float, float, float]]] = {
    "ALA": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0)],
    "GLY": [],
    "SER": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("OG", "CB", "CA", "N", _B["COH"], _TET, 180.0)],
    "CYS": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("SG", "CB", "CA", "N", _B["CS"], _TET, 180.0)],
    "THR": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("OG1", "CB", "CA", "N", _B["COH"], _TET, 180.0),
            ("CG2", "CB", "CA", "N", _B["CC"], _TET, -60.0)],
    "VAL": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG1", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("CG2", "CB", "CA", "N", _B["CC"], _TET, -60.0)],
    "LEU": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("CD1", "CG", "CB", "CA", _B["CC"], _TET, 180.0),
            ("CD2", "CG", "CB", "CA", _B["CC"], _TET, -60.0)],
    "ILE": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG1", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("CG2", "CB", "CA", "N", _B["CC"], _TET, -60.0),
            ("CD1", "CG1", "CB", "CA", _B["CC"], _TET, 180.0)],
    "MET": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("SD", "CG", "CB", "CA", _B["CS"], _TET, 180.0),
            ("CE", "SD", "CG", "CB", _B["CS"], 100.0, 180.0)],
    "PRO": [("CB", "CA", "N", "C", _B["CC"], 103.0, -120.0),
            ("CG", "CB", "CA", "N", _B["CC"], 104.0, 30.0),
            ("CD", "CG", "CB", "CA", _B["CC"], 104.0, -30.0)],
    "PHE": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], 114.0, 180.0),
            ("CD1", "CG", "CB", "CA", _B["CCar"], _SP2, 90.0),
            ("CD2", "CG", "CB", "CA", _B["CCar"], _SP2, -90.0),
            ("CE1", "CD1", "CG", "CB", _B["CCar"], _SP2, 180.0),
            ("CE2", "CD2", "CG", "CB", _B["CCar"], _SP2, 180.0),
            ("CZ", "CE1", "CD1", "CG", _B["CCar"], _SP2, 0.0)],
    "TYR": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], 114.0, 180.0),
            ("CD1", "CG", "CB", "CA", _B["CCar"], _SP2, 90.0),
            ("CD2", "CG", "CB", "CA", _B["CCar"], _SP2, -90.0),
            ("CE1", "CD1", "CG", "CB", _B["CCar"], _SP2, 180.0),
            ("CE2", "CD2", "CG", "CB", _B["CCar"], _SP2, 180.0),
            ("CZ", "CE1", "CD1", "CG", _B["CCar"], _SP2, 0.0),
            ("OH", "CZ", "CE1", "CD1", _B["COH"], _SP2, 180.0)],
    "TRP": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], 114.0, 180.0),
            ("CD1", "CG", "CB", "CA", _B["CCar"], 127.0, 90.0),
            ("CD2", "CG", "CB", "CA", _B["CCar"], 127.0, -90.0),
            ("NE1", "CD1", "CG", "CB", _B["CCar"], 110.0, 180.0),
            ("CE2", "CD2", "CG", "CB", _B["CCar"], 107.0, 180.0),
            ("CE3", "CD2", "CG", "CB", _B["CCar"], 133.0, 0.0),
            ("CZ2", "CE2", "CD2", "CG", _B["CCar"], _SP2, 180.0),
            ("CZ3", "CE3", "CD2", "CG", _B["CCar"], _SP2, 180.0),
            ("CH2", "CZ2", "CE2", "CD2", _B["CCar"], _SP2, 0.0)],
    "ASP": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], 112.0, 180.0),
            ("OD1", "CG", "CB", "CA", _B["CO"], _SP2, 0.0),
            ("OD2", "CG", "CB", "CA", _B["CO"], _SP2, 180.0)],
    "GLU": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("CD", "CG", "CB", "CA", _B["CC"], 112.0, 180.0),
            ("OE1", "CD", "CG", "CB", _B["CO"], _SP2, 0.0),
            ("OE2", "CD", "CG", "CB", _B["CO"], _SP2, 180.0)],
    "ASN": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], 112.0, 180.0),
            ("OD1", "CG", "CB", "CA", _B["CO"], _SP2, 0.0),
            ("ND2", "CG", "CB", "CA", _B["CNsc"], _SP2, 180.0)],
    "GLN": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("CD", "CG", "CB", "CA", _B["CC"], 112.0, 180.0),
            ("OE1", "CD", "CG", "CB", _B["CO"], _SP2, 0.0),
            ("NE2", "CD", "CG", "CB", _B["CNsc"], _SP2, 180.0)],
    "LYS": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("CD", "CG", "CB", "CA", _B["CC"], _TET, 180.0),
            ("CE", "CD", "CG", "CB", _B["CC"], _TET, 180.0),
            ("NZ", "CE", "CD", "CG", _B["CNsc"], _TET, 180.0)],
    "ARG": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], _TET, 180.0),
            ("CD", "CG", "CB", "CA", _B["CC"], _TET, 180.0),
            ("NE", "CD", "CG", "CB", _B["CNsc"], _TET, 180.0),
            ("CZ", "NE", "CD", "CG", _B["CN"], _SP2, 180.0),
            ("NH1", "CZ", "NE", "CD", _B["CNsc"], _SP2, 0.0),
            ("NH2", "CZ", "NE", "CD", _B["CNsc"], _SP2, 180.0)],
    "HIS": [("CB", "CA", "N", "C", _B["CC"], _TET, -122.0),
            ("CG", "CB", "CA", "N", _B["CC"], 114.0, 180.0),
            ("ND1", "CG", "CB", "CA", _B["CCar"], 122.0, 90.0),
            ("CD2", "CG", "CB", "CA", _B["CCar"], 130.0, -90.0),
            ("CE1", "ND1", "CG", "CB", _B["CCar"], 108.0, 180.0),
            ("NE2", "CD2", "CG", "CB", _B["CCar"], 107.0, 180.0)],
}


def _nerf(a: np.ndarray, b: np.ndarray, c: np.ndarray, bond: float, angle_deg: float, dihedral_deg: float) -> np.ndarray:
    """Place atom D from reference frame (A, B, C): |CD|=bond, angle(BCD),
    dihedral(ABCD)."""
    theta = math.radians(angle_deg)
    chi = math.radians(dihedral_deg)
    bc = c - b
    bc /= np.linalg.norm(bc)
    ab = b - a
    n = np.cross(ab, bc)
    n /= max(np.linalg.norm(n), 1e-12)
    m = np.cross(n, bc)
    d_local = np.array(
        [
            -bond * math.cos(theta),
            bond * math.sin(theta) * math.cos(chi),
            bond * math.sin(theta) * math.sin(chi),
        ]
    )
    return c + d_local[0] * bc + d_local[1] * m + d_local[2] * n


def build_peptide(
    sequence: str,
    capped: bool = False,
    phi: float = -135.0,
    psi: float = 135.0,
    omega: float = 180.0,
) -> Tuple[Topology, np.ndarray]:
    """Sequence (one-letter or ALA_GLY style) -> (Topology, [n_atoms, 3] nm)."""
    seq3 = convert_to_three_letter_codes(sequence).split("_")
    residues: List[str] = (["ACE"] if capped else []) + seq3 + (["NME"] if capped else [])

    atoms: List[Atom] = []
    coords: List[np.ndarray] = []
    index_of: Dict[Tuple[int, str], int] = {}

    def add(name: str, element: str, res_name: str, res_idx: int, pos: np.ndarray):
        index_of[(res_idx, name)] = len(atoms)
        atoms.append(
            Atom(index=len(atoms), name=name, element=element, residue_name=res_name,
                 residue_index=res_idx, residue_seq=res_idx + 1)
        )
        coords.append(pos)

    def pos_of(res_idx: int, name: str) -> np.ndarray:
        return coords[index_of[(res_idx, name)]]

    for ri, res in enumerate(residues):
        if res == "ACE":
            # CH3-C(=O)- cap: atoms CH3, C, O
            add("CH3", "C", res, ri, np.array([0.0, 0.0, 0.0]))
            add("C", "C", res, ri, np.array([_B["CC"], 0.0, 0.0]))
            add("O", "O", res, ri, _nerf(np.array([0.0, 0.1, 0.0]), pos_of(ri, "CH3"), pos_of(ri, "C"), _B["CO"], _SP2, 0.0))
            continue
        if res == "NME":
            # -NH-CH3 cap
            prev = ri - 1
            n = _nerf(pos_of(prev, "CA"), pos_of(prev, "C"), pos_of(prev, "O"), _B["CN"], _SP2, 180.0)
            add("N", "N", res, ri, n)
            ch3 = _nerf(pos_of(prev, "O"), pos_of(prev, "C"), n, _B["CaN"], _SP2, 180.0)
            add("CH3", "C", res, ri, ch3)
            continue

        first = ri == 0 or residues[ri - 1] == "ACE"
        if first:
            if ri == 0:
                n = np.array([0.0, 0.0, 0.0])
                ca = np.array([_B["CaN"], 0.0, 0.0])
                c = _nerf(np.array([0.0, 0.1, 0.0]), n, ca, _B["CC"], 111.0, psi)
            else:  # after ACE cap
                prev = ri - 1
                n = _nerf(pos_of(prev, "CH3"), pos_of(prev, "C"), pos_of(prev, "O"), _B["CN"], _SP2, 180.0)
                ca = _nerf(pos_of(prev, "CH3"), pos_of(prev, "C"), n, _B["CaN"], 121.7, 180.0)
                c = _nerf(pos_of(prev, "C"), n, ca, _B["CC"], 111.0, phi)
        else:
            prev = ri - 1
            n = _nerf(pos_of(prev, "N"), pos_of(prev, "CA"), pos_of(prev, "C"), _B["CN"], 116.6, psi)
            ca = _nerf(pos_of(prev, "CA"), pos_of(prev, "C"), n, _B["CaN"], 121.7, omega)
            c = _nerf(pos_of(prev, "C"), n, ca, _B["CC"], 111.0, phi)
        add("N", "N", res, ri, n)
        add("CA", "C", res, ri, ca)
        add("C", "C", res, ri, c)
        o = _nerf(n, ca, c, _B["CO"], _SP2, 0.0 if ri + 1 < len(residues) else 180.0)
        add("O", "O", res, ri, o)
        if ri + 1 == len(residues):  # C-terminal OXT (uncapped only)
            oxt = _nerf(n, ca, c, _B["CO"], _SP2, 0.0)
            add("OXT", "O", res, ri, oxt)

        for name, p, gp, ggp, bond, angle, dihedral in SIDE_CHAINS.get(res, []):
            pos = _nerf(pos_of(ri, ggp), pos_of(ri, gp), pos_of(ri, p), bond, angle, dihedral)
            element = "S" if name.startswith("S") else ("O" if name.startswith("O") else ("N" if name.startswith("N") else "C"))
            add(name, element, res, ri, pos)

    pos = np.asarray(coords, np.float32)
    top = Topology(atoms=atoms, bonds=[])
    top.bonds = infer_bonds(top, pos)
    return top, pos
