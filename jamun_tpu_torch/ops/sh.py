"""Real spherical harmonics up to l = 1 with e3nn "component" normalization.

Counterpart of `jamun_tpu/ops/sh.py` for the irreps `1x0e + 1x1e`, the only
SH the slice's model uses. Input vectors are (x, y, z); the l=1 block is
stored in (y, z, x) order: Y_0 = 1, Y_1 = sqrt(3) * (y, z, x) / |v|.
"""

from __future__ import annotations

import math

import torch

from jamun_tpu_torch.ops.irreps import Irreps

__all__ = ["spherical_harmonics", "SH_IRREPS"]

SH_IRREPS = Irreps("1x0e + 1x1e")
_SQRT3 = math.sqrt(3.0)


def spherical_harmonics(irreps_sh, vectors: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """vectors [..., 3] (x, y, z) -> [..., 4] = [Y_0 | Y_1 (y, z, x)]."""
    if Irreps(irreps_sh) != SH_IRREPS:
        raise NotImplementedError(
            f"only {SH_IRREPS} is ported, got {irreps_sh} (ROADMAP.md queue A, 'General-l irreps')"
        )
    norm = torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
    n = vectors / torch.clamp(norm, min=eps)
    # (y, z, x) from slices: an index list would be copied from the host at
    # every call, and on the card that copy waits for the work queued before it
    y1 = _SQRT3 * torch.cat([n[..., 1:3], n[..., 0:1]], dim=-1)
    return torch.cat([torch.ones_like(y1[..., :1]), y1], dim=-1)
