"""Ramachandran metrics: the torsion histogram, its JSD against the
dataset's reference trajectory, the sliced Wasserstein distance on the
(cos, sin) torsion embedding, and the JSD against the number of samples
(counterpart of `jamun_tpu/metrics/ramachandran.py`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from jamun_tpu_torch.metrics.base import TrajectoryMetric
from jamun_tpu_torch.metrics.dihedrals import compute_phi_psi
from jamun_tpu_torch.metrics.divergences import histogram_jsd_2d, sliced_wasserstein_distance

__all__ = ["RamachandranMetrics"]


class RamachandranMetrics(TrajectoryMetric):
    def __init__(self, dataset, num_bins: int = 50, compare_with_reference: bool = True,
                 max_reference_frames: int = 50_000, vs_num_samples: bool = True):
        super().__init__(dataset)
        self.num_bins = num_bins
        self.compare_with_reference = compare_with_reference
        self.max_reference_frames = max_reference_frames
        self.vs_num_samples = vs_num_samples

    def _torsions(self, pos: np.ndarray):
        phi, psi = compute_phi_psi(self.template.topology, pos)
        return phi, psi

    def compute(self) -> Dict[str, Any]:
        out = super().compute()
        pred = self.joined_positions
        if pred.shape[0] == 0:
            return out
        phi_p, psi_p = self._torsions(pred)
        out["phi"] = phi_p
        out["psi"] = psi_p
        hist, xedges, yedges = np.histogram2d(
            phi_p.ravel(), psi_p.ravel(), bins=self.num_bins, range=((-np.pi, np.pi),) * 2
        )
        out["histogram"] = hist

        if self.compare_with_reference and hasattr(self.dataset, "trajectory"):
            ref = np.asarray(self.dataset.trajectory)[: self.max_reference_frames]
            phi_r, psi_r = self._torsions(ref)
            out["ramachandran_jsd"] = histogram_jsd_2d(
                phi_p, psi_p, phi_r, psi_r, bins=self.num_bins
            )
            emb_p = np.concatenate(
                [np.cos(phi_p), np.sin(phi_p), np.cos(psi_p), np.sin(psi_p)], axis=-1
            )
            emb_r = np.concatenate(
                [np.cos(phi_r), np.sin(phi_r), np.cos(psi_r), np.sin(psi_r)], axis=-1
            )
            out["sliced_wasserstein"] = sliced_wasserstein_distance(emb_p, emb_r)
            if self.vs_num_samples:
                # convergence curve: JSD vs number of samples (log-spaced)
                curve = []
                for n in np.unique(np.geomspace(10, len(phi_p), num=8).astype(int)):
                    curve.append(
                        (
                            int(n),
                            histogram_jsd_2d(
                                phi_p[:n], psi_p[:n], phi_r, psi_r, bins=self.num_bins
                            ),
                        )
                    )
                out["jsd_vs_num_samples"] = curve
        return out
