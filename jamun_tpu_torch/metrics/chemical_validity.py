"""Chemical validity: van der Waals overlap and bond-length sanity rates
(counterpart of `jamun_tpu/metrics/chemical_validity.py`).

`volume_exclusion_rate` takes the frames in chunks of at most
`_FRAMES_PER_CHUNK`: JAX's builds one float64 [frames, n, n, 3] array over
all frames (2.6 GB at 48000 frames of 48 atoms). Each frame's distances and
flag are computed as there, so the fraction and the per-frame mask are
JAX's exactly."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from jamun_tpu_torch.metrics.base import TrajectoryMetric

__all__ = ["ChemicalValidityMetrics", "volume_exclusion_rate", "bond_length_validity_rate"]

# vdW radii (nm), Bondi-style values.
_VDW_RADII = {"C": 0.170, "N": 0.155, "O": 0.152, "S": 0.180, "F": 0.147, "H": 0.120}
# typical heavy-atom covalent bond length window (nm)
_BOND_MIN, _BOND_MAX = 0.09, 0.20
_FRAMES_PER_CHUNK = 1024


def volume_exclusion_rate(pos: np.ndarray, elements, bonded_pairs, tolerance: float = 0.75):
    """Fraction of frames with no non-bonded pair closer than
    tolerance * (r_vdw_i + r_vdw_j), and the per-frame flag. pos: [F, n, 3]."""
    n = pos.shape[1]
    radii = np.asarray([_VDW_RADII.get(e, 0.17) for e in elements])
    thresh = tolerance * (radii[:, None] + radii[None, :])
    mask = ~np.eye(n, dtype=bool)
    for i, j in bonded_pairs:
        mask[i, j] = mask[j, i] = False
    ok = np.empty(pos.shape[0], bool)
    for s in range(0, pos.shape[0], _FRAMES_PER_CHUNK):
        p = pos[s : s + _FRAMES_PER_CHUNK]
        d = np.linalg.norm(p[:, :, None] - p[:, None, :], axis=-1)
        clash = (d < thresh[None]) & mask[None]
        ok[s : s + len(p)] = ~clash.any(axis=(1, 2))
    return float(ok.mean()), ok


def bond_length_validity_rate(pos: np.ndarray, bonded_pairs):
    """Fraction of frames with all bonds inside [_BOND_MIN, _BOND_MAX] nm."""
    if len(bonded_pairs) == 0:
        return 1.0, np.ones(pos.shape[0], bool)
    idx = np.asarray(bonded_pairs)
    d = np.linalg.norm(pos[:, idx[:, 0]] - pos[:, idx[:, 1]], axis=-1)
    ok = ((d > _BOND_MIN) & (d < _BOND_MAX)).all(axis=-1)
    return float(ok.mean()), ok


class ChemicalValidityMetrics(TrajectoryMetric):
    def compute(self) -> Dict[str, Any]:
        out = super().compute()
        pos = self.joined_positions
        if pos.shape[0] == 0:
            return out
        top = self.template.topology
        elements = [a.element or a.name[0] for a in top.atoms]
        pairs = top.bonds
        out["volume_exclusion_rate"], _ = volume_exclusion_rate(pos, elements, pairs)
        out["bond_length_validity_rate"], _ = bond_length_validity_rate(pos, pairs)
        return out
