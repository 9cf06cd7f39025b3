"""PoseBusters chemical-sanity metrics on RDKit molecules of sampled frames
(counterpart of `jamun_tpu/metrics/posebusters.py`). `posebusters` and
`rdkit` are optional: without them the result holds a "skipped" entry, as
in JAX. This is host analysis after sampling; no device path depends on it."""

from __future__ import annotations

import importlib.util
import os
import tempfile
from typing import Any, Dict

import numpy as np

from jamun_tpu_torch.data.topology import save_pdb
from jamun_tpu_torch.metrics.base import TrajectoryMetric

__all__ = ["PoseBustersMetrics"]


class PoseBustersMetrics(TrajectoryMetric):
    def __init__(self, dataset, max_frames: int = 50):
        super().__init__(dataset)
        self.max_frames = max_frames

    def compute(self) -> Dict[str, Any]:
        out = super().compute()
        if importlib.util.find_spec("posebusters") is None or importlib.util.find_spec("rdkit") is None:
            out["posebusters"] = "skipped (posebusters/rdkit not installed)"
            return out
        from posebusters import PoseBusters  # type: ignore
        from rdkit import Chem  # type: ignore

        pos = self.joined_positions
        if pos.shape[0] == 0:
            return out
        idx = np.linspace(0, pos.shape[0] - 1, min(self.max_frames, pos.shape[0])).astype(int)
        buster = PoseBusters(config="mol")
        passes, total = 0, 0
        for i in idx:
            with tempfile.NamedTemporaryFile(suffix=".pdb", delete=False) as f:
                path = f.name
            save_pdb(path, self.template.topology, pos[i : i + 1])
            mol = Chem.MolFromPDBFile(path, sanitize=False)
            os.remove(path)
            if mol is None:
                total += 1
                continue
            df = buster.bust([mol], None, None)
            passes += int(df.all(axis=1).sum())
            total += len(df)
        out["posebusters_pass_rate"] = passes / max(total, 1)
        return out
