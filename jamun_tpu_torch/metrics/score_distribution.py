"""Score-norm statistics over the walk, a cheap health check of the
Langevin walk (counterpart of `jamun_tpu/metrics/score_distribution.py`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from jamun_tpu_torch.metrics.base import TrajectoryMetric

__all__ = ["ScoreDistributionMetrics"]


class ScoreDistributionMetrics(TrajectoryMetric):
    def __init__(self, dataset):
        super().__init__(dataset)
        self.score_chains = []

    def update(self, sample: Dict[str, Any]):
        self.validate(sample)
        s = sample.get("score_traj")
        if s is not None:
            self.score_chains.append(np.asarray(s))  # [atoms, frames, 3]

    def compute(self) -> Dict[str, Any]:
        out = {"num_chains": len(self.score_chains)}
        if not self.score_chains:
            return out
        norms = [np.linalg.norm(c, axis=-1) for c in self.score_chains]  # [atoms, frames]
        per_frame = np.concatenate([n.mean(axis=0) for n in norms])  # frames across chains
        out["score_norm_mean"] = float(per_frame.mean())
        out["score_norm_std"] = float(per_frame.std())
        out["score_norm_max"] = float(max(n.max() for n in norms))
        out["score_norm_per_frame"] = per_frame
        return out
