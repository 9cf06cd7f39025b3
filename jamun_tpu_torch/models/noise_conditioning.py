"""Noise-conditional scaling and skip connections
(counterpart of `jamun_tpu/models/noise_conditioning.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jamun_tpu_torch.ops.tensor_product import scale_irreps
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.mlp import Dense

__all__ = [
    "NoiseConditionalScaling", "NoiseConditionalSkipConnection", "NoiseEmbedding",
    "linear_embedding_transform",
]


class _ScalePredictor(nn.Module):
    """Dense(1 -> n) -> SELU -> Dense(n -> n); the last layer starts at
    weight 0, bias 1, so the initial scaling is the identity."""

    def __init__(self, n: int):
        super().__init__()
        self.Dense_0 = Dense(1, n)
        self.Dense_1 = Dense(n, n, identity_init=True)

    def forward(self, c_noise: torch.Tensor) -> torch.Tensor:
        """c_noise [1] -> [n]."""
        return self.Dense_1(F.selu(self.Dense_0(c_noise.reshape(-1, 1))))[0]


class NoiseConditionalScaling(nn.Module):
    """Multiply every irrep copy by a gain predicted from c_noise."""

    def __init__(self, irreps):
        super().__init__()
        self.irreps = Irreps(irreps)
        self._ScalePredictor_0 = _ScalePredictor(self.irreps.num_irreps)

    def forward(self, x: torch.Tensor, c_noise: torch.Tensor) -> torch.Tensor:
        return scale_irreps(x, self._ScalePredictor_0(c_noise), self.irreps)


class NoiseConditionalSkipConnection(nn.Module):
    """Sigmoid-gated convex blend x1 * w + x2 * (1 - w) per irrep copy."""

    def __init__(self, irreps):
        super().__init__()
        self.irreps = Irreps(irreps)
        self._ScalePredictor_0 = _ScalePredictor(self.irreps.num_irreps)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, c_noise: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self._ScalePredictor_0(c_noise))
        return scale_irreps(x1, w, self.irreps) + scale_irreps(x2, 1.0 - w, self.irreps)


class NoiseEmbedding(nn.Module):
    """MLP embedding of c_noise: Dense(1 -> d), then `num_layers` x (SELU,
    Dense(d -> d)), each Dense at torch.nn.Linear's init (JAX's
    `noise_conditioning.py:81-101`, flax names `Dense_k`). c_noise [B] or
    [B, 1] -> [B, d]."""

    def __init__(self, output_dims: int, num_layers: int = 2):
        super().__init__()
        self.output_dims, self.num_layers = output_dims, num_layers
        self.Dense_0 = Dense(1, output_dims)
        for k in range(num_layers):
            self.add_module(f"Dense_{k + 1}", Dense(output_dims, output_dims))

    def forward(self, c_noise: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(c_noise.reshape(-1, 1))
        for k in range(self.num_layers):
            x = getattr(self, f"Dense_{k + 1}")(F.selu(x))
        return x


def linear_embedding_transform(sigma, scale: float = 1.0, shift: float = 0.0):
    """scale * sigma + shift (JAX's `noise_conditioning.py:104-106`)."""
    return scale * sigma + shift
