"""The runtime equivariance self-test (counterpart of
`jamun_tpu/utils/equivariance.py`): the largest deviation of an arch's
per-atom output from E(3) equivariance under a random rotation and a
translation of the positions. The output is `1x1e` in the (y, z, x) irrep
layout unless the caller names its irreps, which rotate by the block
diagonal Wigner D of `Irreps.rotation_matrix` (`ops/wigner.py`)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.wigner import random_rotation

__all__ = ["random_rotation", "equivariance_error", "assert_arch_equivariant"]


@torch.no_grad()
def equivariance_error(
    apply_fn: Callable[[GraphBatch], torch.Tensor],
    batch: GraphBatch,
    seed: int = 0,
    translation: float = 0.3,
    irreps_out="1x1e",
) -> float:
    """max |apply_fn(R x + t) - D(R) apply_fn(x)| for an output of
    `irreps_out` per atom; raises when apply_fn returns all zeros (a zero
    output gain makes the check vacuous)."""
    R = random_rotation(np.random.default_rng(seed)).astype(np.float32)
    D = Irreps(irreps_out).rotation_matrix(R).astype(np.float32)
    D1 = torch.from_numpy(D).to(batch.pos.device)
    out = apply_fn(batch)
    if float(out.abs().max()) == 0.0:
        raise ValueError(
            "equivariance check is vacuous: apply_fn returned all zeros "
            "(perturb zero-initialized output gains before testing)"
        )
    rotated = batch.replace_pos(batch.pos @ torch.from_numpy(R).to(batch.pos.device).T + translation)
    return float((apply_fn(rotated) - out @ D1.to(out.dtype).T).abs().max())


def assert_arch_equivariant(
    apply_fn, batch: GraphBatch, atol: float = 1e-3, seed: int = 0, irreps_out="1x1e"
) -> float:
    err = equivariance_error(apply_fn, batch, seed=seed, irreps_out=irreps_out)
    if err > atol:
        raise AssertionError(f"architecture is not equivariant: max error {err:.2e} > {atol}")
    return err
