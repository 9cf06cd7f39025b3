"""Regex-driven dataset discovery (counterpart of `jamun_tpu/data/discovery.py`):
(trajectory, pdb) file pairs per molecule code from a directory listing, and
single-frame datasets from raw PDBs.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

from jamun_tpu_torch.data.datasets import IterableTrajectoryDataset, TrajectoryDataset

__all__ = ["parse_datasets_from_directory", "create_dataset_from_pdbs"]


def parse_datasets_from_directory(
    root: str,
    traj_pattern: str,
    pdb_pattern: str,
    max_datasets: Optional[int] = None,
    filter_codes: Optional[Sequence[str]] = None,
    as_iterable: bool = False,
    subsample: Optional[int] = None,
    num_frames: Optional[int] = None,
    start_frame: Optional[int] = None,
    loss_weight: float = 1.0,
    **kwargs,
) -> List:
    """Pair up (trajectory, pdb) files per molecule code via regex capture groups."""
    traj_re, pdb_re = re.compile(traj_pattern), re.compile(pdb_pattern)
    trajs, pdbs = {}, {}
    for fname in sorted(os.listdir(root)):
        m = traj_re.match(fname)
        if m:
            trajs.setdefault(m.group(1), []).append(fname)
        m = pdb_re.match(fname)
        if m:
            pdbs[m.group(1)] = fname
    codes = sorted(set(trajs) & set(pdbs))
    if filter_codes:
        codes = [c for c in codes if c in set(filter_codes)]
    if max_datasets:
        codes = codes[:max_datasets]
    if not codes:
        raise ValueError(
            f"No (trajectory, pdb) pairs found in {root} with patterns "
            f"{traj_pattern!r} / {pdb_pattern!r}"
        )
    datasets = []
    for code in codes:
        if as_iterable:
            datasets.append(
                IterableTrajectoryDataset(
                    root=root,
                    trajfiles=tuple(sorted(trajs[code])),
                    pdbfile=pdbs[code],
                    label=code,
                    subsample=subsample,
                    loss_weight=loss_weight,
                    **kwargs,
                )
            )
        else:
            datasets.append(
                TrajectoryDataset(
                    root=root,
                    trajfiles=tuple(sorted(trajs[code])),
                    pdbfile=pdbs[code],
                    label=code,
                    subsample=subsample,
                    num_frames=num_frames,
                    start_frame=start_frame,
                    loss_weight=loss_weight,
                    **kwargs,
                )
            )
    return datasets


def create_dataset_from_pdbs(
    pdbfiles: Sequence[str],
    root: str = "",
    loss_weight: float = 1.0,
) -> List[TrajectoryDataset]:
    """Single-frame datasets from raw PDBs (custom-sequence sampling path,
    `data/_utils.py:217`)."""
    out = []
    for p in pdbfiles:
        label = os.path.splitext(os.path.basename(p))[0]
        out.append(
            TrajectoryDataset(
                root=root,
                trajfiles=(p,),
                pdbfile=p,
                label=label,
                loss_weight=loss_weight,
            )
        )
    return out
