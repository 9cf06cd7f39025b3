"""The VE-SDE reverse-diffusion sampler (Song and Ermon's discretization),
counterpart of `jamun_tpu/sampling/vesde.py`. JAX runs the N steps as one
`lax.scan`; here they are a Python loop. The schedule is JAX's, in f32 (each
value rounded once from f64; JAX's f32 arithmetic lands within 1e-6 of it):

  sigmas = exp(linspace(log sigma_min, log sigma_max, N)), ts = linspace(1, eps, N)
  step i = N-1 .. 0: score s at sigma_t = sigma_min (sigma_max / sigma_min)^t_i,
  G2 = sigma_i^2 - sigma_{i-1}^2 (sigma_{-1} = 0), xhat_i = y + sigma_i^2 s,
  y_mean = y + G2 s, y = y_mean + sqrt(G2) z

(the score's sigma_t and the update's sigma_i differ, as in JAX). Every
Gaussian draw comes from the caller's `torch.Generator`, and a step takes its
noise `z` as an argument, so a test can feed it numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.parallel.mesh import randn_graphs

__all__ = ["VESDEReverseDiffusionSampler"]


@dataclasses.dataclass
class VESDEReverseDiffusionSampler:
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    N: int = 1000
    eps: float = 1e-5

    @property
    def sigma(self) -> float:
        """The `Sampler`'s noise level: the annealing starts at sigma_max (the
        start positions the `Sampler` makes are ignored, as in JAX)."""
        return self.sigma_max

    def schedule(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sigmas [N], ts [N]), f32."""
        log_smin, log_smax = math.log(self.sigma_min), math.log(self.sigma_max)
        sigmas = np.exp(np.linspace(log_smin, log_smax, self.N))
        return sigmas.astype(np.float32), np.linspace(1.0, self.eps, self.N).astype(np.float32)

    def step(self, denoiser, init_graphs: GraphBatch, y: torch.Tensor, i: int, t_i,
             z: torch.Tensor, sigmas: np.ndarray):
        """Step i at time t_i with the (masked) draw z: (y, y_mean, xhat_i).
        The scalars are f32, as JAX's."""
        f32 = np.float32
        sigma_i = sigmas[i]
        sigma_prev = sigmas[i - 1] if i > 0 else f32(0.0)
        sigma_t = f32(self.sigma_min) * f32(self.sigma_max / self.sigma_min) ** f32(t_i)
        s = denoiser.score(init_graphs.replace_pos(y), float(sigma_t))
        g2 = sigma_i * sigma_i - sigma_prev * sigma_prev  # the forward diffusion's increment
        xhat_i = y + float(sigma_i * sigma_i) * s
        y_mean = y + float(g2) * s
        return y_mean + float(np.sqrt(g2)) * z, y_mean, xhat_i

    @torch.no_grad()
    def anneal(self, denoiser, init_graphs: GraphBatch, y: torch.Tensor,
               noise: Callable[[], torch.Tensor]) -> dict:
        """The N steps from y; `noise()` gives each step's masked draw.
        Returns JAX's outputs: "sample" (the last y_mean), "y", "v" (zeros)
        and the trajectories "y_traj", "y_mean_traj", "xhat_traj" [N, G, n, 3]."""
        sigmas, ts = self.schedule()
        ys, means, xhats = [], [], []
        for n, i in enumerate(range(self.N - 1, -1, -1)):
            y, y_mean, xhat = self.step(denoiser, init_graphs, y, i, ts[n], noise(), sigmas)
            ys.append(y)
            means.append(y_mean)
            xhats.append(xhat)
        y_mean_traj = torch.stack(means)
        return {
            "sample": y_mean_traj[-1],
            "y": y,
            "v": torch.zeros_like(y),
            "y_traj": torch.stack(ys),
            "y_mean_traj": y_mean_traj,
            "xhat_traj": torch.stack(xhats),
        }

    def sample(self, denoiser, init_graphs: GraphBatch, y_init=None,
               generator: torch.Generator = None, v_init=None) -> dict:
        """Anneal from sigma_max noise down to clean samples: the interface
        `Sampler.sample` drives (y_init and v_init are ignored, as in JAX).
        The first draw makes the start, then one per step."""
        pos = init_graphs.pos
        mask = init_graphs.node_mask[..., None].to(pos.dtype)

        def normal():
            return randn_graphs(pos.shape, generator, pos.dtype, pos.device) * mask

        return self.anneal(denoiser, init_graphs, self.sigma_max * normal(), normal)
