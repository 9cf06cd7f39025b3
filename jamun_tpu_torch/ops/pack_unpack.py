"""Multiplicity <-> tensor axis reshaping of packed irreps (counterpart of
`jamun_tpu/ops/pack_unpack.py`, e3tools' `mul_to_axis` / `axis_to_mul`)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from jamun_tpu_torch.ops.irreps import Irreps

__all__ = ["mul_to_axis", "axis_to_mul", "MulToAxis", "AxisToMul"]


def mul_to_axis(x: torch.Tensor, irreps, factor: int) -> Tuple[torch.Tensor, Irreps]:
    """[..., irreps.dim] -> ([..., factor, (irreps / factor).dim], irreps / factor)."""
    irreps = Irreps(irreps)
    batch = x.shape[:-1]
    out_irreps = Irreps([(mi.mul // factor, mi.ir) for mi in irreps])
    parts = []
    for s, mi, fo in zip(irreps.slices(), irreps, out_irreps):
        if mi.mul % factor:
            raise ValueError(f"multiplicity {mi.mul} not divisible by {factor}")
        parts.append(x[..., s].reshape(batch + (factor, fo.mul * mi.ir.dim)))
    return torch.cat(parts, dim=-1), out_irreps


def axis_to_mul(x: torch.Tensor, irreps) -> Tuple[torch.Tensor, Irreps]:
    """[..., factor, irreps.dim] -> ([..., (factor * irreps).dim], factor * irreps)."""
    irreps = Irreps(irreps)
    factor, batch = x.shape[-2], x.shape[:-2]
    parts = [x[..., s].reshape(batch + (factor * mi.dim,)) for s, mi in zip(irreps.slices(), irreps)]
    return torch.cat(parts, dim=-1), Irreps([(factor * mi.mul, mi.ir) for mi in irreps])


class MulToAxis(nn.Module):
    def __init__(self, irreps_in, factor: int):
        super().__init__()
        self.irreps_in, self.factor = Irreps(irreps_in), factor
        self.irreps_out = Irreps([(mi.mul // factor, mi.ir) for mi in self.irreps_in])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mul_to_axis(x, self.irreps_in, self.factor)[0]


class AxisToMul(nn.Module):
    def __init__(self, irreps_in, factor: int):
        super().__init__()
        self.irreps_in, self.factor = Irreps(irreps_in), factor
        self.irreps_out = Irreps([(mi.mul * factor, mi.ir) for mi in self.irreps_in])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return axis_to_mul(x, self.irreps_in)[0]
