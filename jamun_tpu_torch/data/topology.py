"""Minimal molecular topology: atoms, residues, bonds; PDB reading and writing
(the port's own numpy copy of `jamun_tpu/data/topology.py`).

PDB records are parsed by their fixed columns; without CONECT records, bonds
are inferred from covalent radii on the first frame.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from jamun_tpu_torch.data.residue_metadata import (
    ResidueMetadata,
    encode_atom_code,
    encode_atom_type,
    encode_residue,
)

__all__ = ["Atom", "Topology", "load_pdb", "save_pdb", "GraphTemplate", "preprocess_topology"]

# Covalent radii in nm (Cordero et al. 2008), used for bond inference.
_COVALENT_RADII = {
    "H": 0.031, "C": 0.076, "N": 0.071, "O": 0.066, "F": 0.057,
    "S": 0.105, "P": 0.107, "SE": 0.120, "CL": 0.102, "BR": 0.120,
}
_BOND_TOLERANCE = 1.3  # accept bond if dist < tol * (r1 + r2)

_PROTEIN_RESIDUES = set(ResidueMetadata.RESIDUE_CODES) | {"NLE", "HYP", "MSE", "HID", "HIE", "HIP", "CYX", "ASH", "GLH", "LYN"}


@dataclasses.dataclass
class Atom:
    index: int
    name: str
    element: str
    residue_name: str
    residue_index: int  # 0-based consecutive
    residue_seq: int  # PDB resSeq as written
    chain_id: str = "A"
    serial: int = 0


@dataclasses.dataclass
class Topology:
    atoms: List[Atom]
    bonds: List[Tuple[int, int]]  # undirected atom-index pairs

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)

    @property
    def n_residues(self) -> int:
        return max((a.residue_index for a in self.atoms), default=-1) + 1

    def subset(self, indices: Sequence[int]) -> "Topology":
        indices = list(indices)
        remap = {old: new for new, old in enumerate(indices)}
        atoms = []
        # re-index residues consecutively over the kept atoms
        res_remap: Dict[int, int] = {}
        for new, old in enumerate(indices):
            a = self.atoms[old]
            if a.residue_index not in res_remap:
                res_remap[a.residue_index] = len(res_remap)
            atoms.append(
                dataclasses.replace(
                    a, index=new, residue_index=res_remap[a.residue_index]
                )
            )
        bonds = [
            (remap[i], remap[j]) for i, j in self.bonds if i in remap and j in remap
        ]
        return Topology(atoms=atoms, bonds=bonds)

    def select_protein_heavy(self) -> List[int]:
        """Equivalent of mdtraj select("protein and not type H")."""
        return [
            a.index
            for a in self.atoms
            if a.residue_name in _PROTEIN_RESIDUES and _element_of(a) != "H"
        ]

    def select_protein(self) -> List[int]:
        return [a.index for a in self.atoms if a.residue_name in _PROTEIN_RESIDUES]


def _element_of(atom: Atom) -> str:
    if atom.element:
        return atom.element
    # guess from name: strip digits, handle leading columns
    name = atom.name.strip().lstrip("0123456789")
    if not name:
        return "C"
    if name[:2].upper() in ("CL", "BR", "SE", "MG", "ZN", "FE", "NA"):
        return name[:2].capitalize()
    return name[0].upper()


def infer_bonds(topology: Topology, pos_nm: np.ndarray) -> List[Tuple[int, int]]:
    """Distance-based bond inference between atoms of adjacent-or-same residues."""
    n = topology.n_atoms
    elements = [_element_of(a) for a in topology.atoms]
    radii = np.array([_COVALENT_RADII.get(e.upper(), 0.077) for e in elements])
    res_idx = np.array([a.residue_index for a in topology.atoms])
    bonds = []
    d = np.linalg.norm(pos_nm[:, None, :] - pos_nm[None, :, :], axis=-1)
    cut = _BOND_TOLERANCE * (radii[:, None] + radii[None, :])
    cand = (d < cut) & (d > 1e-4)
    # only same or adjacent residues can bond (peptide chain)
    res_ok = np.abs(res_idx[:, None] - res_idx[None, :]) <= 1
    cand &= res_ok
    iu = np.triu_indices(n, k=1)
    for i, j in zip(*iu):
        if cand[i, j]:
            bonds.append((int(i), int(j)))
    return bonds


def load_pdb(path: str, infer_bonds_from_coords: bool = True):
    """Parse a PDB file -> (Topology, positions [n_frames, n_atoms, 3] in nm)."""
    opener = gzip.open if path.endswith(".gz") else open
    atoms: List[Atom] = []
    frames: List[np.ndarray] = []
    coords: List[List[float]] = []
    conect: List[Tuple[int, int]] = []
    serial_to_index: Dict[int, int] = {}
    first_model_done = False
    res_key_to_index: Dict[Tuple[str, int, str], int] = {}

    with opener(path, "rt") as f:
        for line in f:
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                x = float(line[30:38]) / 10.0  # Angstrom -> nm
                y = float(line[38:46]) / 10.0
                z = float(line[46:54]) / 10.0
                coords.append([x, y, z])
                if not first_model_done:
                    serial = int(line[6:11])
                    name = line[12:16].strip()
                    res_name = line[17:20].strip() or line[17:21].strip()
                    chain = line[21].strip() or "A"
                    res_seq = int(line[22:26])
                    element = line[76:78].strip().capitalize() if len(line) >= 78 else ""
                    key = (chain, res_seq, res_name)
                    if key not in res_key_to_index:
                        res_key_to_index[key] = len(res_key_to_index)
                    idx = len(atoms)
                    serial_to_index[serial] = idx
                    atoms.append(
                        Atom(
                            index=idx,
                            name=name,
                            element=element,
                            residue_name=res_name,
                            residue_index=res_key_to_index[key],
                            residue_seq=res_seq,
                            chain_id=chain,
                            serial=serial,
                        )
                    )
            elif rec.startswith("ENDMDL") or rec.startswith("END   ") or line.strip() == "END":
                if coords:
                    frames.append(np.asarray(coords, dtype=np.float32))
                    coords = []
                first_model_done = True
            elif rec.startswith("CONECT"):
                fields = line.split()
                if len(fields) >= 3:
                    a0 = int(fields[1])
                    for s in fields[2:]:
                        conect.append((a0, int(s)))
            elif rec.startswith("MODEL "):
                if coords:
                    frames.append(np.asarray(coords, dtype=np.float32))
                    coords = []
                first_model_done = first_model_done or bool(atoms)
    if coords:
        frames.append(np.asarray(coords, dtype=np.float32))

    n = len(atoms)
    pos = np.stack([f[:n] for f in frames if len(f) >= n], axis=0)
    bonds: List[Tuple[int, int]] = []
    seen = set()
    for s1, s2 in conect:
        if s1 in serial_to_index and s2 in serial_to_index:
            i, j = sorted((serial_to_index[s1], serial_to_index[s2]))
            if (i, j) not in seen:
                seen.add((i, j))
                bonds.append((i, j))
    top = Topology(atoms=atoms, bonds=bonds)
    if not bonds and infer_bonds_from_coords and len(pos):
        top.bonds = infer_bonds(top, pos[0])
    return top, pos


def save_pdb(path: str, topology: Topology, positions_nm: np.ndarray):
    """Write frames [n_frames, n_atoms, 3] (nm) to a PDB file."""
    positions_nm = np.asarray(positions_nm)
    if positions_nm.ndim == 2:
        positions_nm = positions_nm[None]
    with open(path, "w") as f:
        for m, frame in enumerate(positions_nm):
            f.write(f"MODEL     {m + 1:4d}\n")
            for a, (x, y, z) in zip(topology.atoms, frame * 10.0):
                f.write(
                    f"ATOM  {a.index + 1:5d} {a.name:^4s} {a.residue_name:>3s} {a.chain_id:1s}"
                    f"{a.residue_seq:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                    f"          {_element_of(a):>2s}\n"
                )
            f.write("ENDMDL\n")
        f.write("END\n")


@dataclasses.dataclass
class GraphTemplate:
    """Integer-encoded per-atom arrays + bond list for one molecule — the host
    twin of a device `GraphBatch` row. Mirrors `preprocess_topology`
    (`data/_mdtraj.py:56-89`)."""

    atom_type_index: np.ndarray  # [n]
    atom_code_index: np.ndarray
    residue_code_index: np.ndarray
    residue_sequence_index: np.ndarray
    bond_src: np.ndarray  # [2*n_bonds] directed
    bond_dst: np.ndarray
    num_residues: int
    residues: List[str]
    atom_names: List[str]
    topology: Topology
    topology_with_h: Optional[Topology] = None
    dataset_label: str = ""
    loss_weight: float = 1.0

    @property
    def num_atoms(self) -> int:
        return len(self.atom_type_index)


def preprocess_topology(topology: Topology, pos0: Optional[np.ndarray] = None) -> Tuple[GraphTemplate, Topology, Topology]:
    """Select protein heavy atoms, encode vocabularies, build directed bonds."""
    heavy = topology.select_protein_heavy()
    top = topology.subset(heavy)
    top_with_h = topology.subset(topology.select_protein())
    if not top.bonds and pos0 is not None:
        top.bonds = infer_bonds(top, pos0[heavy])
    if not top.bonds and top.n_atoms == top.n_residues > 1:
        # coarse-grained chains (one bead per residue, e.g. IDRome-CG): bead
        # spacing exceeds covalent cutoffs, so chain-link consecutive residues
        top.bonds = [(i, i + 1) for i in range(top.n_atoms - 1)]

    atom_type = np.asarray([encode_atom_type(_element_of(a)) for a in top.atoms], np.int32)
    atom_code = np.asarray([encode_atom_code(a.name) for a in top.atoms], np.int32)
    res_code = np.asarray([encode_residue(a.residue_name) for a in top.atoms], np.int32)
    res_seq = np.asarray([a.residue_index for a in top.atoms], np.int32)

    src = np.asarray([b[0] for b in top.bonds] + [b[1] for b in top.bonds], np.int32)
    dst = np.asarray([b[1] for b in top.bonds] + [b[0] for b in top.bonds], np.int32)

    template = GraphTemplate(
        atom_type_index=atom_type,
        atom_code_index=atom_code,
        residue_code_index=res_code,
        residue_sequence_index=res_seq,
        bond_src=src,
        bond_dst=dst,
        num_residues=top.n_residues,
        residues=[a.residue_name for a in top.atoms],
        atom_names=[a.name for a in top.atoms],
        topology=top,
        topology_with_h=top_with_h,
    )
    return template, top, top_with_h
