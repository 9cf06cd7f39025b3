"""Trajectory datasets: map-style, streaming, and a weighted random interleave
(counterpart of `jamun_tpu/data/datasets.py`, numpy only).

  - `TrajectoryDataset`: one molecule's frames, [start:start+num:subsample];
    `.npz` (key "positions", the Timewarp layout), `.npy`, `.dcd`, `.xtc`
    (the port's trajio library, `data/xtc.py`) or `.pdb` files.
  - `IterableTrajectoryDataset`: the streaming variant, file by file.
  - `StreamingRandomChainDataset`: an epoch-less weighted random interleave
    that re-opens exhausted streams.

A trajectory of the full topology (hydrogens included, as IDRome's
`top.pdb`) is cut to its heavy atoms after reading. Datasets are
deduplicated by their constructor arguments, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from jamun_tpu_torch.data.dcd import read_dcd
from jamun_tpu_torch.data.topology import GraphTemplate, load_pdb, preprocess_topology
from jamun_tpu_torch.data.xtc import read_xtc

__all__ = ["TrajectoryDataset", "IterableTrajectoryDataset", "StreamingRandomChainDataset"]

_singleton_lock = threading.Lock()
_singleton_cache: dict = {}


def _singleton(cls):
    orig_init = cls.__init__

    def __init__(self, *args, **kwargs):
        def freeze(v):
            if isinstance(v, list):
                return tuple(v)
            if isinstance(v, dict):
                return frozenset(v.items())
            return v

        key = (cls.__name__, tuple(freeze(a) for a in args), frozenset((k, freeze(v)) for k, v in kwargs.items()))
        with _singleton_lock:
            if key in _singleton_cache:
                self.__dict__.update(_singleton_cache[key].__dict__)
                return
            _singleton_cache[key] = self
        orig_init(self, *args, **kwargs)

    cls.__init__ = __init__
    return cls


def _load_traj_positions(path: str, heavy_indices: Optional[np.ndarray] = None) -> np.ndarray:
    """Load one trajectory file -> [n_frames, n_atoms(_full), 3] nm."""
    if path.endswith(".npz"):
        return np.load(path)["positions"]
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".dcd"):
        return read_dcd(path)
    if path.endswith(".pdb"):
        _, pos = load_pdb(path)
        return pos
    if path.endswith(".xtc"):
        return read_xtc(path)
    raise ValueError(f"unsupported trajectory format: {path}")


@_singleton
class TrajectoryDataset:
    """Map-style dataset over frames of one molecule's trajectory files."""

    def __init__(
        self,
        root: str,
        trajfiles: Sequence[str],
        pdbfile: str,
        label: str,
        num_frames: Optional[int] = None,
        start_frame: Optional[int] = None,
        subsample: Optional[int] = None,
        loss_weight: float = 1.0,
        transform: Optional[Callable] = None,
        verbose: bool = False,
    ):
        self.root = root
        self._label = label
        self.transform = transform
        pdb_path = os.path.join(root, pdbfile)
        trajfiles = [os.path.join(root, t) for t in trajfiles]

        full_top, pdb_pos = load_pdb(pdb_path)
        self.template, self.top, self.top_with_h = preprocess_topology(
            full_top, pdb_pos[0] if len(pdb_pos) else None
        )
        self.template.dataset_label = label
        self.template.loss_weight = loss_weight

        heavy = np.asarray(full_top.select_protein_heavy())
        xyz = np.concatenate([_load_traj_positions(t) for t in trajfiles], axis=0)
        if xyz.shape[1] == full_top.n_atoms:
            xyz = xyz[:, heavy]
        elif xyz.shape[1] != self.template.num_atoms:
            raise ValueError(
                f"trajectory atom count {xyz.shape[1]} matches neither full topology "
                f"({full_top.n_atoms}) nor heavy-atom selection ({self.template.num_atoms})"
            )
        start = start_frame or 0
        if num_frames in (None, -1):
            num_frames = xyz.shape[0] - start
        sub = subsample or 1
        self.xyz = np.ascontiguousarray(xyz[start : start + num_frames : sub], dtype=np.float32)

    def label(self) -> str:
        return self._label

    def __len__(self) -> int:
        return self.xyz.shape[0]

    def __getitem__(self, idx: int) -> Tuple[GraphTemplate, np.ndarray]:
        item = (self.template, self.xyz[idx])
        return self.transform(item) if self.transform else item

    @property
    def topology(self):
        return self.top

    @property
    def trajectory(self) -> np.ndarray:
        return self.xyz


@_singleton
class IterableTrajectoryDataset:
    """Streaming dataset: yields frames chunk-by-chunk without materializing
    the full trajectory (for MDGen/IDRome-scale data)."""

    def __init__(
        self,
        root: str,
        trajfiles: Sequence[str],
        pdbfile: str,
        label: str,
        subsample: Optional[int] = None,
        loss_weight: float = 1.0,
        chunk_size: int = 100,
        start_at_random_frame: bool = False,
        transform: Optional[Callable] = None,
        verbose: bool = False,
    ):
        self.root = root
        self._label = label
        self.transform = transform
        self.chunk_size = chunk_size
        self.subsample = subsample or 1
        self.start_at_random_frame = start_at_random_frame
        self.trajfiles = [os.path.join(root, t) for t in trajfiles]

        full_top, pdb_pos = load_pdb(os.path.join(root, pdbfile))
        self.template, self.top, self.top_with_h = preprocess_topology(
            full_top, pdb_pos[0] if len(pdb_pos) else None
        )
        self.template.dataset_label = label
        self.template.loss_weight = loss_weight
        self._heavy = np.asarray(full_top.select_protein_heavy())
        self._full_n = full_top.n_atoms

    def label(self) -> str:
        return self._label

    def __iter__(self) -> Iterator[Tuple[GraphTemplate, np.ndarray]]:
        return self.frames(shuffle_files=self.start_at_random_frame)

    def frames(self, shuffle_files: bool = False) -> Iterator[Tuple[GraphTemplate, np.ndarray]]:
        """The stream; its files in their listed order unless
        `shuffle_files` (then in `np.random`'s order, as JAX's iterator)."""
        files = list(self.trajfiles)
        if shuffle_files:
            files = list(np.random.permutation(files))
        for path in files:
            xyz = _load_traj_positions(path)
            if xyz.shape[1] == self._full_n:
                xyz = xyz[:, self._heavy]
            for frame in xyz[:: self.subsample]:
                item = (self.template, np.asarray(frame, np.float32))
                yield self.transform(item) if self.transform else item


class StreamingRandomChainDataset:
    """Infinite weighted random interleave of iterable datasets; exhausted
    streams are re-opened (`data/_random_chain_dataset.py:33-50`)."""

    def __init__(self, datasets: Sequence, weights: Optional[Sequence[float]] = None, seed: int = 0):
        self.datasets = list(datasets)
        w = np.asarray(weights if weights is not None else [1.0] * len(self.datasets), float)
        self.probs = w / w.sum()
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        iters: List[Optional[Iterator]] = [None] * len(self.datasets)
        while True:
            i = int(rng.choice(len(self.datasets), p=self.probs))
            if iters[i] is None:
                iters[i] = iter(self.datasets[i])
            try:
                yield next(iters[i])
            except StopIteration:
                iters[i] = iter(self.datasets[i])
                yield next(iters[i])
