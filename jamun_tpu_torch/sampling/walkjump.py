"""Walk-jump sampling: a Langevin walk in noised space, then the denoiser jump.

Counterpart of `jamun_tpu/sampling/walkjump.py:51-86`. The jump of the saved
frames is fused: BAOAB saves the raw score at every saved state, and
score(y) = (xhat(y) - y) / sigma^2, so xhat = y + sigma^2 * score costs no
extra denoiser forward. The final state is jumped with one forward.
"""

from __future__ import annotations

import dataclasses

import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.sampling.mcmc import BAOAB

__all__ = ["SingleMeasurementSampler"]


@dataclasses.dataclass
class SingleMeasurementSampler:
    mcmc: BAOAB
    sigma: float

    @torch.no_grad()
    def walk(self, denoiser, init_graphs: GraphBatch, y_init: torch.Tensor,
             generator: torch.Generator, v_init="gaussian"):
        mask = init_graphs.node_mask[..., None].to(y_init.dtype)

        def score_fn(y):
            return denoiser.score(init_graphs.replace_pos(y), self.sigma)

        y, v, y_traj, score_traj = self.mcmc(y_init, score_fn, generator, v_init=v_init, mask=mask)
        return {"y": y, "v": v, "y_traj": y_traj, "score_traj": score_traj}

    @torch.no_grad()
    def walk_jump(self, denoiser, init_graphs: GraphBatch, y_init: torch.Tensor,
                  generator: torch.Generator, v_init="gaussian"):
        out = self.walk(denoiser, init_graphs, y_init, generator, v_init)
        xhat = denoiser.xhat(init_graphs.replace_pos(out["y"]), self.sigma)
        xhat_traj = out["y_traj"] + (self.sigma**2) * out["score_traj"]
        return {**out, "xhat": xhat, "xhat_traj": xhat_traj}
