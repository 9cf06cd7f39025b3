"""Noise-level (sigma) sampling distributions (counterpart of
`jamun_tpu/train/distributions.py`). Each is a small dataclass with
`sample(generator, shape=()) -> torch.Tensor` (f32, on the generator's
device). torch's generators give other numbers than JAX's keys from the
same seed; the distributions are the same."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

__all__ = [
    "ConstantSigma",
    "UniformSigma",
    "ExponentialSigma",
    "ClippedLogNormalSigma",
    "UniformPlusNormal",
    "CategoricalValue",
    "WeightedMeasurement",
    "UniformMeasurement",
]


def _uniform(generator, shape, low=0.0, high=1.0):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (high - low) * u


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device)


@dataclasses.dataclass(frozen=True)
class ConstantSigma:
    sigma: float = 0.04

    def sample(self, generator, shape: Tuple[int, ...] = ()):
        return torch.full(shape, self.sigma, dtype=torch.float32, device=generator.device)

    @property
    def mean(self):
        return self.sigma


@dataclasses.dataclass(frozen=True)
class UniformSigma:
    sigma_max: float
    sigma_min: float = 1e-4

    def sample(self, generator, shape=()):
        return _uniform(generator, shape, self.sigma_min, self.sigma_max)


@dataclasses.dataclass(frozen=True)
class ExponentialSigma:
    """Log-uniform in [sigma_min, sigma_max]."""

    sigma_max: float = 50.0
    sigma_min: float = 1e-2
    epsilon: float = 1e-5

    def sample(self, generator, shape=()):
        t = _uniform(generator, shape, self.epsilon, 1.0)
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t


@dataclasses.dataclass(frozen=True)
class ClippedLogNormalSigma:
    log_sigma_mean: float
    log_sigma_std: float
    sigma_max: float = 100.0

    def sample(self, generator, shape=()):
        log_sigma = self.log_sigma_mean + self.log_sigma_std * _normal(generator, shape)
        return torch.clamp(torch.exp(log_sigma), max=self.sigma_max)


@dataclasses.dataclass(frozen=True)
class UniformPlusNormal:
    sigma: float
    sample_shape: Tuple[int, ...] = ()

    def sample(self, generator, shape=()):
        full = tuple(shape) + tuple(self.sample_shape)
        return _uniform(generator, full) + _normal(generator, full) * self.sigma


@dataclasses.dataclass(frozen=True)
class CategoricalValue:
    values: Tuple[float, ...]
    probs: Tuple[float, ...]

    def sample(self, generator, shape=()):
        dev = generator.device
        p = torch.tensor(self.probs, dtype=torch.float32, device=dev)
        n = math.prod(shape)
        idx = torch.multinomial(p / p.sum(), max(n, 1), replacement=True, generator=generator)
        vals = torch.tensor(self.values, dtype=torch.float32, device=dev)[idx[:n]]
        return vals.reshape(shape)

    @property
    def mean(self):
        total = sum(self.probs)
        return float(sum(v * p / total for v, p in zip(self.values, self.probs)))


def WeightedMeasurement(sigma: float, probs: Sequence[float]) -> CategoricalValue:
    """sigma ladder sigma * k^{-1/2}, k = 1..m (multi-measurement training)."""
    m = len(probs)
    values = tuple(sigma * (k**-0.5) for k in range(1, m + 1))
    return CategoricalValue(values=values, probs=tuple(probs))


def UniformMeasurement(sigma: float, m: int) -> CategoricalValue:
    return WeightedMeasurement(sigma, [1.0] * m)
