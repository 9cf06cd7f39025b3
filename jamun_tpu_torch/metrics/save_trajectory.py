"""Sampled trajectories on disk, the sampler's main output (counterpart of
`jamun_tpu/metrics/save_trajectory.py`): per graph and batch
`<output_dir>/<label>/predicted_samples/batch_<b>_graph_<g>.{npy,pdb,dcd}`,
and at the end `joined_trajectory.dcd` and `topology.pdb`."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from jamun_tpu_torch.data.dcd import write_dcd
from jamun_tpu_torch.data.topology import save_pdb
from jamun_tpu_torch.metrics.base import TrajectoryMetric

__all__ = ["SaveTrajectory"]


class SaveTrajectory(TrajectoryMetric):
    def __init__(self, dataset, output_dir: str = "sampler", formats=("npy", "pdb", "dcd")):
        super().__init__(dataset)
        self.output_dir = os.path.join(output_dir, dataset.label(), "predicted_samples")
        self.formats = formats
        self._batch_counter = 0

    def update(self, sample: Dict[str, Any]):
        super().update(sample)
        traj = sample.get("xhat_traj")
        if traj is None:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        pos = np.transpose(np.asarray(traj), (1, 0, 2))  # [frames, atoms, 3]
        stem = os.path.join(
            self.output_dir, f"batch_{self._batch_counter}_graph_{sample.get('graph_index', 0)}"
        )
        if "npy" in self.formats:
            np.save(stem + ".npy", pos)
        if "pdb" in self.formats:
            save_pdb(stem + ".pdb", self.template.topology, pos[:1])
        if "dcd" in self.formats:
            write_dcd(stem + ".dcd", pos)
        self._batch_counter += 1

    def compute(self) -> Dict[str, Any]:
        out = super().compute()
        joined = self.joined_positions
        if joined.shape[0]:
            os.makedirs(self.output_dir, exist_ok=True)
            path = os.path.join(self.output_dir, "joined_trajectory.dcd")
            write_dcd(path, joined)
            save_pdb(os.path.join(self.output_dir, "topology.pdb"), self.template.topology, joined[:1])
            out["joined_trajectory_path"] = path
        return out
