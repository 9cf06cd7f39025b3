"""The data normalization pre-pass: the average squared pairwise distance
under the cutoff (the port's own numpy copy of
`jamun_tpu/utils/average_squared_distance.py`), a plain host loop over the
datasets. A streaming dataset (no `len`, as the IDRome and MDGen configs
read theirs) gives its first frames, its files in their listed order
whatever `start_at_random_frame` says, so the constant is the same on every
run; JAX's raises TypeError on one.
"""

from __future__ import annotations

import itertools
import logging
from typing import Optional

import numpy as np

log = logging.getLogger("jamun_tpu_torch")

__all__ = ["compute_average_squared_distance", "compute_average_squared_distance_from_datasets"]


def compute_average_squared_distance(pos: np.ndarray, cutoff: float) -> Optional[float]:
    """Mean squared pairwise distance among pairs with distance < cutoff.
    pos: [n_atoms, 3]."""
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    n = pos.shape[0]
    mask = (d2 < cutoff**2) & ~np.eye(n, dtype=bool)
    if not mask.any():
        return None
    return float(d2[mask].mean())


def compute_average_squared_distance_from_datasets(
    datasets, cutoff: float, max_graphs: int = 5000, seed: int = 0
) -> float:
    rng = np.random.default_rng(seed)
    vals = []
    per_ds = max(1, max_graphs // max(len(datasets), 1))
    for ds in datasets:
        if hasattr(ds, "__len__"):
            n = len(ds)
            idx = rng.choice(n, size=min(per_ds, n), replace=False)
            frames = (ds[int(i)] for i in idx)
        else:  # a stream: its first frames
            frames = itertools.islice(ds.frames(), per_ds)
        for _, pos in frames:
            v = compute_average_squared_distance(np.asarray(pos), cutoff)
            if v is not None:
                vals.append(v)
            if len(vals) >= max_graphs:
                break
    result = float(np.mean(vals))
    log.info("average squared distance over %d graphs: %.6f", len(vals), result)
    return result
