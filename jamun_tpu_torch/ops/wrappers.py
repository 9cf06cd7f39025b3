"""Small equivariant wrapper modules (counterpart of
`jamun_tpu/ops/wrappers.py`): `Gated`, `GateWrapper`,
`LinearSelfInteraction`, `LearnableSkipConnection` and `GateActivation`.
Submodules carry flax's names, so `params.from_jax_params` maps a JAX tree
onto them one to one.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from jamun_tpu_torch.ops.gate import Gate
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.linear import IrrepsLinear

__all__ = [
    "Gated",
    "GateWrapper",
    "LinearSelfInteraction",
    "LearnableSkipConnection",
    "GateActivation",
]


class Gated(nn.Module):
    """A layer followed by an equivariant gate: `layer(irreps_in=...,
    irreps_out=gate.irreps_in)` is built here and named as flax names it
    (its class name and `_0`)."""

    def __init__(self, layer: Callable[..., nn.Module], irreps_in, irreps_out):
        super().__init__()
        self.gate = Gate(Irreps(irreps_out))
        f = layer(irreps_in=Irreps(irreps_in), irreps_out=self.gate.irreps_in)
        self._name = f"{type(f).__name__}_0"
        self.add_module(self._name, f)

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return self.gate(getattr(self, self._name)(*args, **kwargs))


class GateWrapper(nn.Module):
    """Linear -> gate -> linear."""

    def __init__(self, irreps_in, irreps_out):
        super().__init__()
        self.gate = Gate(Irreps(irreps_out))
        self.IrrepsLinear_0 = IrrepsLinear(irreps_in, self.gate.irreps_in)
        self.IrrepsLinear_1 = IrrepsLinear(self.gate.irreps_out, irreps_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.IrrepsLinear_1(self.gate(self.IrrepsLinear_0(x)))


class LinearSelfInteraction(nn.Module):
    """out = IrrepsLinear_1(f(x, ...)) + IrrepsLinear_0(x); `f` maps
    irreps_in to irreps_out."""

    def __init__(self, f: nn.Module, irreps_in, irreps_out):
        super().__init__()
        self.f = f
        self.IrrepsLinear_0 = IrrepsLinear(irreps_in, irreps_out)
        self.IrrepsLinear_1 = IrrepsLinear(irreps_out, irreps_out)

    def forward(self, x: torch.Tensor, *args) -> torch.Tensor:
        skip = self.IrrepsLinear_0(x)
        return self.IrrepsLinear_1(self.f(x, *args)) + skip


class LearnableSkipConnection(nn.Module):
    """The sigmoid-gated blend w x1 + (1 - w) x2, w = sigmoid(alpha), alpha
    starting at 1."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.alpha.data.fill_(1.0)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.alpha)
        return w * x1 + (1.0 - w) * x2


class GateActivation(nn.Module):
    """The equivariant gate as a module of its own."""

    def __init__(self, irreps_out):
        super().__init__()
        self.gate = Gate(Irreps(irreps_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gate(x)
