"""Masked mean-centering of padded [G, N, 3] batches
(counterpart of `jamun_tpu/ops/geometry.py:mean_center`)."""

from __future__ import annotations

import torch

__all__ = ["mean_center"]


def mean_center(pos: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Subtract the per-graph masked centroid; padded atoms are zeroed."""
    m = node_mask[..., None].to(pos.dtype)
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (pos * m).sum(dim=1, keepdim=True) / count
    return (pos - mean) * m
