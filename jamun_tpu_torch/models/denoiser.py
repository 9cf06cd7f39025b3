"""Denoiser core: EDM-style preconditioning around the E3Conv network.

Counterpart of `jamun_tpu/models/denoiser.py:30-146` (the sampling side):

  A = average_squared_distance, B = 2 * D * sigma^2
  c_in = 1/sqrt(A+B), c_skip = A/(A+B), c_out = sqrt(A*B/(A+B)), c_noise = log(sigma)/4
  effective_radial_cutoff = sqrt(max_radius^2 + 6 sigma^2)
  xhat = c_skip * y + c_out * g(c_in * y, c_noise, cutoff / c_in)
  score = (xhat - y) / sigma^2

sigma is a Python float (one noise level per walk), so the factors are
host scalars and the forward makes no host-device round trip for them.
The training side (noise, loss) is a later slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from jamun_tpu_torch.models.e3conv import irreps_to_vector
from jamun_tpu_torch.ops.geometry import mean_center
from jamun_tpu_torch.ops.graph import GraphBatch

__all__ = ["DenoiserConfig", "Denoiser", "normalization_factors"]


def normalization_factors(sigma: float, average_squared_distance: float, D: int = 3):
    A = float(average_squared_distance)
    B = 2.0 * D * float(sigma) ** 2
    c_in = 1.0 / math.sqrt(A + B)
    c_skip = A / (A + B)
    c_out = math.sqrt((A * B) / (A + B))
    c_noise = math.log(float(sigma)) / 4.0
    return c_in, c_skip, c_out, c_noise


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    max_radius: float
    average_squared_distance: float
    mean_center: bool = True


class Denoiser:
    """Wraps an E3Conv with the preconditioning; `score` feeds the walk."""

    def __init__(self, arch, config: DenoiserConfig):
        self.arch = arch
        self.config = config

    def effective_radial_cutoff(self, sigma: float) -> float:
        return math.sqrt(self.config.max_radius**2 + 6.0 * float(sigma) ** 2)

    def xhat_normalized(self, y: GraphBatch, sigma: float) -> torch.Tensor:
        D = y.pos.shape[-1]
        c_in, c_skip, c_out, c_noise = normalization_factors(
            sigma, self.config.average_squared_distance, D
        )
        radial_cutoff = self.effective_radial_cutoff(sigma) / c_in
        c_noise_t = torch.full((1,), c_noise, dtype=torch.float32, device=y.pos.device)
        g_out = self.arch(y.replace_pos(y.pos * c_in), c_noise_t, radial_cutoff)
        return c_skip * y.pos + c_out * irreps_to_vector(g_out)

    def xhat(self, y: GraphBatch, sigma: float) -> torch.Tensor:
        pos = y.pos
        if self.config.mean_center:
            pos = mean_center(pos, y.node_mask)
        xhat_pos = self.xhat_normalized(y.replace_pos(pos), sigma)
        if self.config.mean_center:
            xhat_pos = mean_center(xhat_pos, y.node_mask)
        return xhat_pos

    def score(self, y: GraphBatch, sigma: float) -> torch.Tensor:
        """score(y, sigma) = (xhat(y) - y) / sigma^2."""
        return (self.xhat(y, sigma) - y.pos) / float(sigma) ** 2
