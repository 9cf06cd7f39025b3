"""Synthetic molecular graph batches (the port's numpy copy of
`jamun_tpu/utils/testing.py`: same seeds, same numbers), two stand-ins
for driving `Trainer.fit` on fixed batches (a datamodule and a logger that
keeps what it is given), and synthetic IDRome-layout trees: `build_peptide`
chains of disordered-region sequences with their hydrogens, as `.xtc`
trajectories, and their CA beads as `.dcd` (the coarse-grained layout)."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.utils.device import resolve_device

__all__ = [
    "make_test_arrays", "make_test_batch", "make_chain_positions", "FixedBatches", "RecordingLogger",
    "idr_sequence", "with_hydrogens", "write_idrome_tree", "write_cg_tree",
]


def make_chain_positions(
    num_graphs: int, n_atoms: int, seed: int = 0, bond: float = 0.152, persistence: float = 0.7
) -> np.ndarray:
    """Worm-like-chain conformations (nm): unit steps with direction momentum."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((num_graphs, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = np.zeros((num_graphs, n_atoms, 3), dtype=np.float32)
    for i in range(1, n_atoms):
        d = persistence * d + (1.0 - persistence) * rng.standard_normal((num_graphs, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pos[:, i] = pos[:, i - 1] + bond * d
    return pos - pos.mean(axis=1, keepdims=True)


def make_test_arrays(
    num_graphs: int = 2,
    max_nodes: int = 8,
    nodes_per_graph=None,
    max_bonds: int = 16,
    seed: int = 0,
    scale: float = 0.3,
    dtype=np.float32,
) -> dict:
    """A random peptide-like batch as numpy arrays: chain-bonded points in a
    ~`scale` nm blob (the field names of GraphBatch)."""
    rng = np.random.default_rng(seed)
    G, N, B = num_graphs, max_nodes, max_bonds
    if nodes_per_graph is None:
        nodes_per_graph = [N - (g % 2) for g in range(G)]
    pos = rng.standard_normal((G, N, 3)).astype(dtype) * scale
    node_mask = np.zeros((G, N), dtype=bool)
    bond_src = np.zeros((G, B), dtype=np.int32)
    bond_dst = np.zeros((G, B), dtype=np.int32)
    bond_mask = np.zeros((G, B), dtype=bool)
    for g, n in enumerate(nodes_per_graph):
        node_mask[g, :n] = True
        pos[g, n:] = 0.0
        k = 0
        for i in range(n - 1):  # chain bonds, both directions
            if k + 2 > B:
                break
            bond_src[g, k], bond_dst[g, k] = i, i + 1
            bond_src[g, k + 1], bond_dst[g, k + 1] = i + 1, i
            k += 2
        bond_mask[g, :k] = True
    return dict(
        pos=pos,
        node_mask=node_mask,
        atom_type_index=rng.integers(0, 5, (G, N)).astype(np.int32) * node_mask,
        atom_code_index=rng.integers(0, 6, (G, N)).astype(np.int32) * node_mask,
        residue_code_index=rng.integers(0, 22, (G, N)).astype(np.int32) * node_mask,
        residue_sequence_index=rng.integers(0, 4, (G, N)).astype(np.int32) * node_mask,
        bond_src=bond_src,
        bond_dst=bond_dst,
        bond_mask=bond_mask,
        loss_weight=np.ones((G,), dtype=dtype),
        graph_mask=np.ones((G,), dtype=bool),
    )


def make_test_batch(*args, device=None, **kwargs) -> GraphBatch:
    """`make_test_arrays` as a GraphBatch on `device` (the card unless "cpu");
    index tensors are int64."""
    device = resolve_device(device)
    arrays = make_test_arrays(*args, **kwargs)
    tensors = {}
    for k, a in arrays.items():
        t = torch.from_numpy(a)
        if a.dtype == np.int32:
            t = t.to(torch.int64)
        tensors[k] = t.to(device)
    return GraphBatch(**tensors)


@dataclasses.dataclass
class FixedBatches:
    """A datamodule of fixed batches for `Trainer.fit`: the same training
    batches in every epoch, and the validation batches (none by default)."""

    train: Sequence[GraphBatch]
    val: Sequence[GraphBatch] = ()

    def train_batches(self, epoch: int = 0):
        return iter(self.train)

    def val_batches(self):
        return iter(self.val)


class RecordingLogger:
    """A logger that keeps every (step, metrics) it is given, in order."""

    def __init__(self):
        self.metrics: List[Tuple[int, Dict[str, float]]] = []

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self.metrics.append((step, dict(metrics)))

    def finalize(self) -> None:
        pass


# residues of intrinsically disordered regions, drawn with these weights
# (G, S, P, E, K, Q, N, D, R, A, T, and few hydrophobic or aromatic ones)
_IDR_RESIDUES = "GSPEKQNDRATVLFY"
_IDR_WEIGHTS = np.array([12, 11, 9, 9, 8, 6, 5, 6, 5, 7, 5, 4, 4, 2, 2], float)


def idr_sequence(n_heavy: int, seed: int = 0) -> str:
    """A disordered-region-like sequence whose uncapped `build_peptide`
    chain has about `n_heavy` heavy atoms (within one residue's)."""
    from jamun_tpu_torch.data.peptide_builder import SIDE_CHAINS
    from jamun_tpu_torch.data.residue_metadata import convert_to_three_letter_codes

    rng = np.random.default_rng(seed)
    seq, atoms = "", 1  # the C-terminal OXT
    while atoms < n_heavy:
        aa = _IDR_RESIDUES[rng.choice(len(_IDR_RESIDUES), p=_IDR_WEIGHTS / _IDR_WEIGHTS.sum())]
        seq += aa
        atoms += 4 + len(SIDE_CHAINS[convert_to_three_letter_codes(aa)])
    return seq


def with_hydrogens(top, pos: np.ndarray):
    """The topology and positions with an amide H on every backbone N and an
    HA on every CA, placed after each residue's heavy atoms, as an all-atom
    PDB lists them (bonds inferred again from the positions)."""
    from jamun_tpu_torch.data.topology import Atom, Topology, infer_bonds

    atoms, coords = [], []
    for r in range(top.n_residues):
        res = [a for a in top.atoms if a.residue_index == r]
        at = {a.name: pos[a.index] for a in res}
        extra = []
        if "N" in at and "CA" in at:
            u = at["N"] - at["CA"]
            extra.append(("H", at["N"] + 0.101 * u / np.linalg.norm(u)))
        if "CA" in at and "C" in at:
            u = at["CA"] - at["C"]
            extra.append(("HA", at["CA"] + 0.109 * u / np.linalg.norm(u)))
        for a in res:
            atoms.append(dataclasses.replace(a, index=len(atoms)))
            coords.append(pos[a.index])
        for name, x in extra:
            atoms.append(Atom(index=len(atoms), name=name, element="H", residue_name=res[0].residue_name,
                              residue_index=r, residue_seq=res[0].residue_seq))
            coords.append(x)
    out = Topology(atoms=atoms, bonds=[])
    coords = np.asarray(coords, np.float32)
    out.bonds = infer_bonds(out, coords)
    return out, coords


def write_idrome_tree(root: str, sequences: Dict[str, str], frames: int, seed: int = 0,
                      noise: float = 0.02) -> Dict[str, int]:
    """IDRome's layout, `<root>/<name>/traj.xtc` and `<root>/<name>/top.pdb`:
    each sequence's `build_peptide` chain with its hydrogens
    (`with_hydrogens`) in the PDB, and `frames` frames of it plus
    N(0, noise nm) on every atom in the XTC (the port's `write_xtc`, all
    atoms). Returns each name's heavy-atom count."""
    from jamun_tpu_torch.data.peptide_builder import build_peptide
    from jamun_tpu_torch.data.topology import save_pdb
    from jamun_tpu_torch.data.xtc import write_xtc

    rng = np.random.default_rng(seed)
    heavy = {}
    for name, seq in sequences.items():
        top, pos = build_peptide(seq)
        full, full_pos = with_hydrogens(top, pos)
        os.makedirs(os.path.join(root, name), exist_ok=True)
        save_pdb(os.path.join(root, name, "top.pdb"), full, full_pos)
        traj = full_pos[None] + rng.normal(0.0, noise, (frames,) + full_pos.shape)
        write_xtc(os.path.join(root, name, "traj.xtc"), traj.astype(np.float32))
        heavy[name] = top.n_atoms
    return heavy


def write_cg_tree(root: str, sequences: Dict[str, str], frames: int, seed: int = 0,
                  noise: float = 0.02) -> Dict[str, int]:
    """The coarse-grained layout `<root>/<name>.pdb` and `<root>/<name>.dcd`:
    one bead per residue at the `build_peptide` chain's CA, `frames` frames
    plus N(0, noise nm). Returns each name's bead count."""
    from jamun_tpu_torch.data.dcd import write_dcd
    from jamun_tpu_torch.data.peptide_builder import build_peptide
    from jamun_tpu_torch.data.topology import save_pdb

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    beads = {}
    for name, seq in sequences.items():
        top, pos = build_peptide(seq)
        ca = [a.index for a in top.atoms if a.name == "CA"]
        cg = top.subset(ca)
        save_pdb(os.path.join(root, f"{name}.pdb"), cg, pos[ca])
        traj = pos[ca][None] + rng.normal(0.0, noise, (frames, len(ca), 3))
        write_dcd(os.path.join(root, f"{name}.dcd"), traj.astype(np.float32))
        beads[name] = len(ca)
    return beads
