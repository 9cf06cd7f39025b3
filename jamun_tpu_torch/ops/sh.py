"""Real spherical harmonics with e3nn "component" normalization
(counterpart of `jamun_tpu/ops/sh.py`).

Input vectors are (x, y, z); the l=1 block is stored in (y, z, x) order:
Y_0 = 1, Y_1 = sqrt(3) * (y, z, x) / |v|. Higher l come from the recursive
coupling Y_l = c_l * w3j(1, l-1, l) . (Y_1 (x) Y_{l-1}) with the host's
constants (`ops/cg.py`), so any lmax works. `SH_IRREPS`, `1x0e + 1x1e`, is
the case the kernels take; it is built from slices alone.
"""

from __future__ import annotations

import functools
import math

import torch

from jamun_tpu_torch.ops.cg import real_wigner_3j, sh_normalization_constant
from jamun_tpu_torch.ops.irreps import Irreps

__all__ = ["spherical_harmonics", "SH_IRREPS"]

SH_IRREPS = Irreps("1x0e + 1x1e")
_SQRT3 = math.sqrt(3.0)


@functools.lru_cache(maxsize=None)
def _coupling(l: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """c_l * w3j(1, l-1, l), made once per device: a host tensor copied at
    every call would make the host wait for the device."""
    c = real_wigner_3j(1, l - 1, l) * sh_normalization_constant(l)
    return torch.as_tensor(c, dtype=dtype, device=device)


def spherical_harmonics(irreps_sh, vectors: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """vectors [..., 3] (x, y, z) -> [..., irreps_sh.dim], one Y_l per copy
    of each block of `irreps_sh` (vectors normalized first)."""
    irreps_sh = Irreps(irreps_sh)
    norm = torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
    n = vectors / torch.clamp(norm, min=eps)
    # (y, z, x) from slices: an index list would be copied from the host at
    # every call, and on the card that copy waits for the work queued before it
    y1 = _SQRT3 * torch.cat([n[..., 1:3], n[..., 0:1]], dim=-1)
    ys = {0: torch.ones_like(y1[..., :1]), 1: y1}
    for l in range(2, irreps_sh.lmax + 1):
        ys[l] = torch.einsum("ijk,...i,...j->...k", _coupling(l, y1.dtype, y1.device), y1, ys[l - 1])
    return torch.cat([ys[mi.ir.l] for mi in irreps_sh for _ in range(mi.mul)], dim=-1)
