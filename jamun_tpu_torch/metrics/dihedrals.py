"""Backbone torsions (phi, psi) from a topology and coordinates, host numpy
(counterpart of `jamun_tpu/metrics/dihedrals.py`)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from jamun_tpu_torch.data.topology import Topology

__all__ = ["dihedral_angles", "phi_psi_indices", "compute_phi_psi"]


def dihedral_angles(pos: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """pos: [..., n_atoms, 3]; quads: [m, 4] atom indices -> angles [..., m] (radians)."""
    p = pos[..., quads, :]  # [..., m, 4, 3]
    b1 = p[..., 1, :] - p[..., 0, :]
    b2 = p[..., 2, :] - p[..., 1, :]
    b3 = p[..., 3, :] - p[..., 2, :]
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=-1, keepdims=True))
    x = np.sum(n1 * n2, axis=-1)
    y = np.sum(m1 * n2, axis=-1)
    return np.arctan2(y, x)


def _backbone_map(topology: Topology) -> List[dict]:
    res: List[dict] = [dict() for _ in range(topology.n_residues)]
    for a in topology.atoms:
        if a.name in ("N", "CA", "C"):
            res[a.residue_index][a.name] = a.index
    return res


def phi_psi_indices(topology: Topology) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (phi_quads [m,4], psi_quads [m,4])."""
    bb = _backbone_map(topology)
    phi, psi = [], []
    for i in range(len(bb)):
        # phi_i: C(i-1), N(i), CA(i), C(i)
        if i > 0 and all(k in bb[i] for k in ("N", "CA", "C")) and "C" in bb[i - 1]:
            phi.append([bb[i - 1]["C"], bb[i]["N"], bb[i]["CA"], bb[i]["C"]])
        # psi_i: N(i), CA(i), C(i), N(i+1)
        if i + 1 < len(bb) and all(k in bb[i] for k in ("N", "CA", "C")) and "N" in bb[i + 1]:
            psi.append([bb[i]["N"], bb[i]["CA"], bb[i]["C"], bb[i + 1]["N"]])
    return np.asarray(phi, np.int64).reshape(-1, 4), np.asarray(psi, np.int64).reshape(-1, 4)


def compute_phi_psi(topology: Topology, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """pos: [n_frames, n_atoms, 3] -> (phi [n_frames, m], psi [n_frames, m])."""
    phi_q, psi_q = phi_psi_indices(topology)
    phi = dihedral_angles(pos, phi_q) if len(phi_q) else np.zeros((len(pos), 0))
    psi = dihedral_angles(pos, psi_q) if len(psi_q) else np.zeros((len(pos), 0))
    return phi, psi
