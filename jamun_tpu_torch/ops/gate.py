"""Equivariant gate nonlinearity (counterpart of `jamun_tpu/ops/gate.py`).

Input layout: scalars ++ gates ++ gated. Even scalars get LeakyReLU(0.01)
(odd: tanh); the gates (one 0e per gated irrep copy) get sigmoid and scale
their l > 0 copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.tensor_product import scale_irreps

__all__ = ["Gate", "scale_irreps"]


class Gate:
    """Stateless callable built from the target output irreps."""

    def __init__(self, irreps_out):
        irreps_out = Irreps(irreps_out)
        self.irreps_scalars = Irreps([mi for mi in irreps_out if mi.ir.l == 0])
        self.irreps_gated = Irreps([mi for mi in irreps_out if mi.ir.l > 0])
        self.irreps_gates = Irreps([(mi.mul, "0e") for mi in self.irreps_gated])
        self.irreps_in = self.irreps_scalars + self.irreps_gates + self.irreps_gated
        self.irreps_out = (self.irreps_scalars + self.irreps_gated).simplify()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        d_s, d_g = self.irreps_scalars.dim, self.irreps_gates.dim
        scalars, gates, gated = x[..., :d_s], x[..., d_s : d_s + d_g], x[..., d_s + d_g :]
        out, ix = [], 0
        for mi in self.irreps_scalars:
            s = scalars[..., ix : ix + mi.dim]
            out.append(F.leaky_relu(s, 0.01) if mi.ir.p == 1 else torch.tanh(s))
            ix += mi.dim
        if d_g:
            gated = scale_irreps(gated, torch.sigmoid(gates), self.irreps_gated)
        out.append(gated)
        return torch.cat(out, dim=-1)
