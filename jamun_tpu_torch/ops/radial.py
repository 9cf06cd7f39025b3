"""Radial basis embedding (e3nn `soft_one_hot_linspace`, Gaussian basis).

Counterpart of `jamun_tpu/ops/radial.py` with `cutoff=True`: n centres at
k * end / (n + 1) for k = 1..n, width one grid step, divided by 1.12.
"""

from __future__ import annotations

import torch

__all__ = ["soft_one_hot_linspace"]


def soft_one_hot_linspace(x: torch.Tensor, start: float, end, number: int) -> torch.Tensor:
    """x [...] -> [..., number]. The grid excludes the interval endpoints, so
    the basis decays toward both ends."""
    i = torch.arange(1, number + 1, dtype=x.dtype, device=x.device)
    step = (end - start) / (number + 1)
    values = start + (end - start) * i / (number + 1)
    diff = (x[..., None] - values) / step
    return torch.exp(-(diff**2)) / 1.12
