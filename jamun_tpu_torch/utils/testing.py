"""Synthetic molecular graph batches (the port's numpy copy of
`jamun_tpu/utils/testing.py`: same seeds, same numbers), and two stand-ins
for driving `Trainer.fit` on fixed batches: a datamodule and a logger that
keeps what it is given."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.utils.device import resolve_device

__all__ = [
    "make_test_arrays", "make_test_batch", "make_chain_positions", "FixedBatches", "RecordingLogger",
]


def make_chain_positions(
    num_graphs: int, n_atoms: int, seed: int = 0, bond: float = 0.152, persistence: float = 0.7
) -> np.ndarray:
    """Worm-like-chain conformations (nm): unit steps with direction momentum."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((num_graphs, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = np.zeros((num_graphs, n_atoms, 3), dtype=np.float32)
    for i in range(1, n_atoms):
        d = persistence * d + (1.0 - persistence) * rng.standard_normal((num_graphs, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pos[:, i] = pos[:, i - 1] + bond * d
    return pos - pos.mean(axis=1, keepdims=True)


def make_test_arrays(
    num_graphs: int = 2,
    max_nodes: int = 8,
    nodes_per_graph=None,
    max_bonds: int = 16,
    seed: int = 0,
    scale: float = 0.3,
    dtype=np.float32,
) -> dict:
    """A random peptide-like batch as numpy arrays: chain-bonded points in a
    ~`scale` nm blob (the field names of GraphBatch)."""
    rng = np.random.default_rng(seed)
    G, N, B = num_graphs, max_nodes, max_bonds
    if nodes_per_graph is None:
        nodes_per_graph = [N - (g % 2) for g in range(G)]
    pos = rng.standard_normal((G, N, 3)).astype(dtype) * scale
    node_mask = np.zeros((G, N), dtype=bool)
    bond_src = np.zeros((G, B), dtype=np.int32)
    bond_dst = np.zeros((G, B), dtype=np.int32)
    bond_mask = np.zeros((G, B), dtype=bool)
    for g, n in enumerate(nodes_per_graph):
        node_mask[g, :n] = True
        pos[g, n:] = 0.0
        k = 0
        for i in range(n - 1):  # chain bonds, both directions
            if k + 2 > B:
                break
            bond_src[g, k], bond_dst[g, k] = i, i + 1
            bond_src[g, k + 1], bond_dst[g, k + 1] = i + 1, i
            k += 2
        bond_mask[g, :k] = True
    return dict(
        pos=pos,
        node_mask=node_mask,
        atom_type_index=rng.integers(0, 5, (G, N)).astype(np.int32) * node_mask,
        atom_code_index=rng.integers(0, 6, (G, N)).astype(np.int32) * node_mask,
        residue_code_index=rng.integers(0, 22, (G, N)).astype(np.int32) * node_mask,
        residue_sequence_index=rng.integers(0, 4, (G, N)).astype(np.int32) * node_mask,
        bond_src=bond_src,
        bond_dst=bond_dst,
        bond_mask=bond_mask,
        loss_weight=np.ones((G,), dtype=dtype),
        graph_mask=np.ones((G,), dtype=bool),
    )


def make_test_batch(*args, device=None, **kwargs) -> GraphBatch:
    """`make_test_arrays` as a GraphBatch on `device` (the card unless "cpu");
    index tensors are int64."""
    device = resolve_device(device)
    arrays = make_test_arrays(*args, **kwargs)
    tensors = {}
    for k, a in arrays.items():
        t = torch.from_numpy(a)
        if a.dtype == np.int32:
            t = t.to(torch.int64)
        tensors[k] = t.to(device)
    return GraphBatch(**tensors)


@dataclasses.dataclass
class FixedBatches:
    """A datamodule of fixed batches for `Trainer.fit`: the same training
    batches in every epoch, and the validation batches (none by default)."""

    train: Sequence[GraphBatch]
    val: Sequence[GraphBatch] = ()

    def train_batches(self, epoch: int = 0):
        return iter(self.train)

    def val_batches(self):
        return iter(self.val)


class RecordingLogger:
    """A logger that keeps every (step, metrics) it is given, in order."""

    def __init__(self):
        self.metrics: List[Tuple[int, Dict[str, float]]] = []

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self.metrics.append((step, dict(metrics)))

    def finalize(self) -> None:
        pass
