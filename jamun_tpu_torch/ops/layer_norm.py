"""Equivariant layer norm (counterpart of `jamun_tpu/ops/layer_norm.py`,
Equiformer's fast layer norm): each 0e block is normalized over its
multiplicity (mean and variance, no affine parameters); every other block
is divided by the RMS of its copies' L2 norms."""

from __future__ import annotations

import torch

from jamun_tpu_torch.ops.irreps import Irreps, unpack_irreps

__all__ = ["equivariant_layer_norm"]


def equivariant_layer_norm(x: torch.Tensor, irreps, eps: float = 1e-6) -> torch.Tensor:
    irreps = Irreps(irreps)
    batch = x.shape[:-1]
    fields = []
    for mul, ir, field in unpack_irreps(x, irreps):
        if ir.l == 0 and ir.p == 1:
            mean = field.mean(dim=(-2, -1), keepdim=True)
            var = field.var(dim=(-2, -1), keepdim=True, unbiased=False)
            fields.append(((field - mean) / torch.sqrt(var + eps)).reshape(batch + (mul,)))
            continue
        norm2 = (field**2).sum(dim=-1)  # [..., mul]
        inv_rms = (norm2.mean(dim=-1) + eps) ** -0.5  # [...]
        fields.append((field * inv_rms[..., None, None]).reshape(batch + (mul * ir.dim,)))
    return torch.cat(fields, dim=-1)
