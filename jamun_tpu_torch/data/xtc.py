"""GROMACS XTC trajectories (counterpart of `jamun_tpu/data/xtc.py`): read
through the port's trajio library (`_native_io`, built with g++ at first
use). Positions in nm, float32 [frames, atoms, 3]."""

from __future__ import annotations

import numpy as np

from jamun_tpu_torch.data import _native_io

__all__ = ["read_xtc", "write_xtc"]


def read_xtc(path: str) -> np.ndarray:
    return _native_io.read_xtc(path)


def write_xtc(path: str, pos_nm: np.ndarray, precision: float = 1000.0) -> None:
    _native_io.write_xtc(path, pos_nm, precision)
