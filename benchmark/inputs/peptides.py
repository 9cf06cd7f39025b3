"""Heavy-atom peptide structures from a sequence and per-residue backbone
dihedrals, and the integer features the denoiser reads.

A copy of the port's builder and featuriser (`jamun_tpu_torch/data/
peptide_builder.py`, `data/topology.py`, `data/residue_metadata.py`), kept
here so that a change to the program cannot change the benchmark's inputs.
It differs in two ways: `build_peptide` takes a phi and a psi per residue
instead of one pair for the chain, so a seed can draw each residue's
backbone, and it places each carbonyl O anti to the next residue's N at any
psi. Atoms are placed by NeRF from idealized internal coordinates;
bonds are inferred from covalent radii, as the port infers them for a
structure without CONECT records.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["build_peptide", "featurize", "SIDE_CHAINS", "AA_3CODES", "heavy_atom_count"]

ATOM_TYPES = ["C", "O", "N", "F", "S"]
ATOM_CODES = ["C", "O", "N", "S", "CA", "CB"]
RESIDUE_CODES = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLU", "GLN", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "ACE", "NME",
]
AA_3CODES = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "E": "GLU", "Q": "GLN", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}
# covalent radii in nm (Cordero et al. 2008) and the bond test's tolerance
_COVALENT_RADII = {"C": 0.076, "N": 0.071, "O": 0.066, "S": 0.105}
_BOND_TOLERANCE = 1.3

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


def heavy_atom_count(sequence: str) -> int:
    """Heavy atoms of the uncapped peptide: four backbone atoms a residue,
    its side chain, and the C-terminal OXT."""
    return sum(4 + len(SIDE_CHAINS[AA_3CODES[a]]) for a in sequence) + 1


def _nerf(a, b, c, bond: float, angle_deg: float, dihedral_deg: float) -> np.ndarray:
    """Place atom D from reference frame (A, B, C): |CD| = bond, angle(BCD),
    dihedral(ABCD)."""
    theta = math.radians(angle_deg)
    chi = math.radians(dihedral_deg)
    bc = c - b
    bc /= np.linalg.norm(bc)
    ab = b - a
    n = np.cross(ab, bc)
    n /= max(np.linalg.norm(n), 1e-12)
    m = np.cross(n, bc)
    d_local = np.array([
        -bond * math.cos(theta),
        bond * math.sin(theta) * math.cos(chi),
        bond * math.sin(theta) * math.sin(chi),
    ])
    return c + d_local[0] * bc + d_local[1] * m + d_local[2] * n


def _element(name: str) -> str:
    return "S" if name.startswith("S") else ("O" if name.startswith("O") else (
        "N" if name.startswith("N") else "C"))


def build_peptide(sequence: str, phi: Sequence[float], psi: Sequence[float], omega: float = 180.0):
    """One-letter sequence, phi and psi per residue (degrees) -> (atoms, pos):
    atoms a list of (name, element, residue name, residue index), pos
    [n_atoms, 3] float32 nm. Uncapped, with the C-terminal OXT."""
    residues = [AA_3CODES[a] for a in sequence]
    if len(phi) != len(residues) or len(psi) != len(residues):
        raise ValueError("one phi and one psi per residue")
    atoms: List[Tuple[str, str, str, int]] = []
    coords: List[np.ndarray] = []
    index_of: Dict[Tuple[int, str], int] = {}

    def add(name: str, element: str, res: str, ri: int, pos: np.ndarray):
        index_of[(ri, name)] = len(atoms)
        atoms.append((name, element, res, ri))
        coords.append(pos)

    def pos_of(ri: int, name: str) -> np.ndarray:
        return coords[index_of[(ri, name)]]

    for ri, res in enumerate(residues):
        if ri == 0:
            n = np.array([0.0, 0.0, 0.0])
            ca = np.array([_B["CaN"], 0.0, 0.0])
            c = _nerf(np.array([0.0, 0.1, 0.0]), n, ca, _B["CC"], 111.0, psi[0])
        else:
            prev = ri - 1
            n = _nerf(pos_of(prev, "N"), pos_of(prev, "CA"), pos_of(prev, "C"), _B["CN"], 116.6, psi[prev])
            ca = _nerf(pos_of(prev, "CA"), pos_of(prev, "C"), n, _B["CaN"], 121.7, omega)
            c = _nerf(pos_of(prev, "C"), n, ca, _B["CC"], 111.0, phi[ri])
        add("N", "N", res, ri, n)
        add("CA", "C", res, ri, ca)
        add("C", "C", res, ri, c)
        last = ri + 1 == len(residues)
        # anti to the next residue's N: the port's builder places O at 0 degrees,
        # which is near that only for its extended chains (psi 135)
        add("O", "O", res, ri, _nerf(n, ca, c, _B["CO"], _SP2, 180.0 if last else psi[ri] + 180.0))
        if last:
            add("OXT", "O", res, ri, _nerf(n, ca, c, _B["CO"], _SP2, 0.0))
        for name, p, gp, ggp, bond, angle, dihedral in SIDE_CHAINS[res]:
            pos = _nerf(pos_of(ri, ggp), pos_of(ri, gp), pos_of(ri, p), bond, angle, dihedral)
            add(name, _element(name), res, ri, pos)
    return atoms, np.asarray(coords, np.float32)


def _bonds(atoms, pos: np.ndarray) -> List[Tuple[int, int]]:
    """Covalent-radius bond inference between atoms of the same or adjacent
    residues (the port's `infer_bonds`)."""
    radii = np.array([_COVALENT_RADII.get(a[1], 0.077) for a in atoms])
    res_idx = np.array([a[3] for a in atoms])
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    cand = (d < _BOND_TOLERANCE * (radii[:, None] + radii[None, :])) & (d > 1e-4)
    cand &= np.abs(res_idx[:, None] - res_idx[None, :]) <= 1
    i, j = np.nonzero(np.triu(cand, k=1))
    return list(zip(i.tolist(), j.tolist()))


def _index(vocab: List[str], name: str) -> int:
    return vocab.index(name) if name in vocab else len(vocab)


def featurize(atoms, pos: np.ndarray) -> dict:
    """The per-atom integer features and the directed bonds of one molecule
    (the port's `preprocess_topology`)."""
    bonds = _bonds(atoms, pos)
    src = [b[0] for b in bonds] + [b[1] for b in bonds]
    dst = [b[1] for b in bonds] + [b[0] for b in bonds]
    return dict(
        pos=pos,
        atom_type_index=np.asarray([_index(ATOM_TYPES, a[1]) for a in atoms], np.int64),
        atom_code_index=np.asarray([_index(ATOM_CODES, a[0]) for a in atoms], np.int64),
        residue_code_index=np.asarray([_index(RESIDUE_CODES, a[2]) for a in atoms], np.int64),
        residue_sequence_index=np.asarray([a[3] for a in atoms], np.int64),
        bond_src=np.asarray(src, np.int64),
        bond_dst=np.asarray(dst, np.int64),
    )
