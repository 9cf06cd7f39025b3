"""Sampled trajectories and sampling rates of a run directory (counterpart
of `jamun_tpu/analysis/load_trajectory.py`): runs live on the local file
system as `<run_dir>/sampler/<label>/predicted_samples/`, and rates in a CSV
with JAX's columns and order."""

from __future__ import annotations

import csv
import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from jamun_tpu_torch.data.dcd import read_dcd
from jamun_tpu_torch.data.topology import Topology, load_pdb

__all__ = ["load_run_trajectory", "list_run_labels", "get_sampling_rate", "write_sampling_times_csv"]


def list_run_labels(run_dir: str) -> List[str]:
    base = os.path.join(run_dir, "sampler")
    if not os.path.isdir(base):
        return []
    return sorted(
        d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d, "predicted_samples"))
    )


def load_run_trajectory(run_dir: str, label: str) -> Tuple[Topology, np.ndarray]:
    """Returns (heavy-atom topology, positions [frames, atoms, 3] nm): the
    joined trajectory, else every batch's .npy in file-name order."""
    base = os.path.join(run_dir, "sampler", label, "predicted_samples")
    top, _ = load_pdb(os.path.join(base, "topology.pdb"))
    joined = os.path.join(base, "joined_trajectory.dcd")
    if os.path.exists(joined):
        return top, read_dcd(joined)
    parts = sorted(glob.glob(os.path.join(base, "batch_*.npy")))
    if not parts:
        raise FileNotFoundError(f"no trajectories under {base}")
    return top, np.concatenate([np.load(p) for p in parts], axis=0)


def write_sampling_times_csv(path: str, rates) -> None:
    """rates: label -> seconds per sample (float), or label -> dict of
    columns (with "time_per_sample_seconds"; the other columns, such as
    "time_per_sample_seconds_incl_compile", "samples" and the overflow
    statistics, follow in sorted order). `get_sampling_rate` reads the warm
    "time_per_sample_seconds"."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rows = {
        label: (r if isinstance(r, dict) else {"time_per_sample_seconds": r})
        for label, r in rates.items()
    }
    extra_cols = sorted({k for r in rows.values() for k in r} - {"time_per_sample_seconds"})
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["label", "time_per_sample_seconds", *extra_cols])
        for label, r in sorted(rows.items()):
            w.writerow([label, r["time_per_sample_seconds"], *(r.get(c, "") for c in extra_cols)])


def get_sampling_rate(csv_path: str, label: str) -> Optional[float]:
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            if row.get("label") == label:
                return float(row["time_per_sample_seconds"])
    return None
