"""The runtime equivariance self-test (counterpart of
`jamun_tpu/utils/equivariance.py`): the largest deviation of an arch's
per-atom l=1 output, in the (y, z, x) irrep layout, from E(3) equivariance
under a random rotation and a translation of the positions."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch

__all__ = ["random_rotation", "equivariance_error", "assert_arch_equivariant"]


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform random proper rotation matrix (3x3), as JAX's
    `jamun_tpu/ops/wigner.random_rotation` draws it."""
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


@torch.no_grad()
def equivariance_error(
    apply_fn: Callable[[GraphBatch], torch.Tensor],
    batch: GraphBatch,
    seed: int = 0,
    translation: float = 0.3,
) -> float:
    """max |apply_fn(R x + t) - D(R) apply_fn(x)|; raises when apply_fn
    returns all zeros (a zero output gain makes the check vacuous)."""
    R = random_rotation(np.random.default_rng(seed)).astype(np.float32)
    perm = [1, 2, 0]
    D1 = torch.from_numpy(R[np.ix_(perm, perm)]).to(batch.pos.device)
    out = apply_fn(batch)
    if float(out.abs().max()) == 0.0:
        raise ValueError(
            "equivariance check is vacuous: apply_fn returned all zeros "
            "(perturb zero-initialized output gains before testing)"
        )
    rotated = batch.replace_pos(batch.pos @ torch.from_numpy(R).to(batch.pos.device).T + translation)
    return float((apply_fn(rotated) - out @ D1.T).abs().max())


def assert_arch_equivariant(apply_fn, batch: GraphBatch, atol: float = 1e-3, seed: int = 0) -> float:
    err = equivariance_error(apply_fn, batch, seed=seed)
    if err > atol:
        raise AssertionError(f"architecture is not equivariant: max error {err:.2e} > {atol}")
    return err
