"""Scalar and equivariant MLP stacks (counterpart of `jamun_tpu/ops/mlp.py`).

`Dense` keeps flax's parameter orientation: `kernel` is [in, out] and the
layer computes x @ kernel + bias. `ScalarMLP` is the radial network that makes
the tensor-product weights; `EquivariantMLP` is the gated head, for any
hidden irreps list (each block's gate takes its l > 0 copies), with JAX's
`use_layer_norm` (`ops/layer_norm.py` on each block's gate input).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jamun_tpu_torch.ops.gate import Gate
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.layer_norm import equivariant_layer_norm
from jamun_tpu_torch.ops.linear import IrrepsLinear

__all__ = [
    "Dense", "ScalarMLP", "EquivariantMLP", "torch_linear_kernel_init", "torch_linear_bias_init",
    "xla_sigmoid", "silu",
]


def _uniform(generator: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    return ((torch.rand(tuple(shape), generator=generator) * 2 - 1) * bound).to(dtype)


def torch_linear_kernel_init(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """torch.nn.Linear's default for a kernel [fan_in, out]: U(+-1/sqrt(fan_in))
    (JAX's initializer of the same name, drawn from a torch generator)."""
    return _uniform(generator, shape, shape[0] ** -0.5, dtype)


def torch_linear_bias_init(fan_in: int):
    """torch.nn.Linear's default for a bias: an initializer
    (generator, shape, dtype) -> U(+-1/sqrt(fan_in))."""

    def init(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
        return _uniform(generator, shape, fan_in**-0.5, dtype)

    return init


class Dense(nn.Module):
    """x @ kernel + bias, kernel [in, out] (flax `nn.Dense` layout).
    `identity_init` starts the layer at kernel 0, bias 1."""

    def __init__(self, in_features: int, out_features: int, identity_init: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.identity_init = identity_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch.nn.Linear's default: U(+-1/sqrt(fan_in)) for kernel and bias."""
        if self.identity_init:
            self.kernel.data.zero_()
            self.bias.data.fill_(1.0)
            return
        self.kernel.data.copy_(torch_linear_kernel_init(generator, self.kernel.shape))
        self.bias.data.copy_(torch_linear_bias_init(self.kernel.shape[0])(generator, self.bias.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class _XlaSigmoid(torch.autograd.Function):
    """The sigmoid as XLA evaluates JAX's `logistic` op by op, 1 / (1 +
    exp(-t)) in t's dtype, with the derivative JAX takes, s (1 - s). The
    quotient's own derivative is NaN where exp(-t) overflows (t below about
    -88): 0 * inf in the exponential's backward."""

    @staticmethod
    def forward(ctx, t):
        s = 1 / (1 + torch.exp(-t))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        return grad * (s * (1 - s))


def xla_sigmoid(t: torch.Tensor) -> torch.Tensor:
    """JAX's sigmoid with XLA's rounding points in t's dtype (`_XlaSigmoid`)."""
    return _XlaSigmoid.apply(t)


def silu(x: torch.Tensor) -> torch.Tensor:
    """JAX's `nn.silu`, x * sigmoid(x), with XLA's rounding points in a 16-bit
    dtype: each of exp, 1 + ., 1 / . and the product rounded to x's dtype
    (torch's fused SiLU rounds once). f32 and wider take `F.silu`."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x * xla_sigmoid(x)
    return F.silu(x)


class ScalarMLP(nn.Module):
    """Dense -> SiLU per hidden width, then a final Dense; in a 16-bit
    compute dtype the SiLU rounds where JAX's XLA path rounds (`silu`)."""

    def __init__(self, in_features: int, out_features: int, hidden_features: Sequence[int]):
        super().__init__()
        widths = [in_features, *hidden_features, out_features]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))

    def layer(self, i: int) -> Dense:
        return getattr(self, f"Dense_{i}")

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the final Dense layer."""
        for i in range(self.n_layers - 1):
            x = silu(self.layer(i)(x))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(self.n_layers - 1)(self.hidden(x))

    def split_forward(self, x: torch.Tensor, slices) -> list:
        """The output's columns at each of `slices`, one tensor each: the
        final Dense layer runs on each slice's columns, so no tensor of all
        the outputs is made (nor its gradient in the backward)."""
        h = self.hidden(x)
        last = self.layer(self.n_layers - 1)
        kernel, bias = last.kernel.to(h.dtype), last.bias.to(h.dtype)
        return [h @ kernel[:, s] + bias[s] for s in slices]


class EquivariantMLPBlock(nn.Module):
    def __init__(self, irreps_in, irreps_out, use_layer_norm: bool = False):
        super().__init__()
        self.gate = Gate(Irreps(irreps_out))
        self.use_layer_norm = use_layer_norm
        self.IrrepsLinear_0 = IrrepsLinear(irreps_in, self.gate.irreps_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.IrrepsLinear_0(x)
        if self.use_layer_norm:
            x = equivariant_layer_norm(x, self.gate.irreps_in)
        return self.gate(x)


class EquivariantMLP(nn.Module):
    """Gated blocks, one per hidden irreps, then a final IrrepsLinear."""

    def __init__(self, irreps_in, irreps_out, irreps_hidden_list=(), use_layer_norm: bool = False):
        super().__init__()
        irreps = Irreps(irreps_in)
        self.n_blocks = len(irreps_hidden_list)
        for i, hidden in enumerate(irreps_hidden_list):
            blk = EquivariantMLPBlock(irreps, Irreps(hidden), use_layer_norm)
            self.add_module(f"EquivariantMLPBlock_{i}", blk)
            irreps = blk.gate.irreps_out
        self.IrrepsLinear_0 = IrrepsLinear(irreps, Irreps(irreps_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"EquivariantMLPBlock_{i}")(x)
        return self.IrrepsLinear_0(x)
