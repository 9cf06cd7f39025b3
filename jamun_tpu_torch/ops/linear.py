"""Equivariant linear layer on packed irreps tensors (e3nn `o3.Linear`).

Counterpart of `jamun_tpu/ops/linear.py`: each output block sums every input
block of the same irrep through a [mul_in, mul_out] kernel named
`w_{i_in}_{i_out}` (flax's names and orientation), scaled by
1/sqrt(total fan-in multiplicity).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from jamun_tpu_torch.ops.irreps import Irreps

__all__ = ["IrrepsLinear"]


class IrrepsLinear(nn.Module):
    def __init__(self, irreps_in, irreps_out):
        super().__init__()
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        self.paths = []  # (i_in, i_out)
        for i_out, mi_out in enumerate(self.irreps_out):
            for i_in, mi_in in enumerate(self.irreps_in):
                if mi_in.ir == mi_out.ir:
                    self.paths.append((i_in, i_out))
                    self.register_parameter(
                        f"w_{i_in}_{i_out}", nn.Parameter(torch.empty(mi_in.mul, mi_out.mul))
                    )
        self.fan_in = [
            sum(mi.mul for mi in self.irreps_in if mi.ir == mo.ir) for mo in self.irreps_out
        ]

    def weight(self, i_in: int, i_out: int) -> torch.Tensor:
        return getattr(self, f"w_{i_in}_{i_out}")

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i_in, i_out in self.paths:
            w = self.weight(i_in, i_out)
            w.data.copy_(torch.randn(w.shape, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[-1] == self.irreps_in.dim, f"{x.shape} vs {self.irreps_in}"
        batch = x.shape[:-1]
        sl_in = self.irreps_in.slices()
        blocks = []
        for i_out, mi_out in enumerate(self.irreps_out):
            acc = None
            for i_in, mi_in in enumerate(self.irreps_in):
                if mi_in.ir != mi_out.ir:
                    continue
                f = x[..., sl_in[i_in]].reshape(batch + (mi_in.mul, mi_in.ir.dim))
                blk = torch.einsum("...ui,uw->...wi", f, self.weight(i_in, i_out).to(x.dtype))
                acc = blk if acc is None else acc + blk
            if acc is None:
                acc = x.new_zeros(batch + (mi_out.mul, mi_out.ir.dim))
            else:
                acc = acc / math.sqrt(max(self.fan_in[i_out], 1))
            blocks.append(acc.reshape(batch + (mi_out.dim,)))
        return torch.cat(blocks, dim=-1)
