"""The BAOAB walk in chunks (counterpart of `jamun_tpu/sampling/unrolled.py`).

JAX compiles `chunk_steps` BAOAB updates into one program and loops over the
chunks on the host. Here each chunk is a Python loop of `mcmc.BAOAB.step`,
so the walk is BAOAB's, with JAX's semantics:
  - each chunk evaluates the score again at its first position (one more
    score call per chunk; the same value as BAOAB's carried score);
  - `(steps - 1) // chunk_steps` whole chunks run, the `(steps - 1) %
    chunk_steps` remaining updates are dropped;
  - the frames are the start and every update, thinned by
    `save_every_n_steps` (`burn_in_steps` is not read), and the score
    trajectory is zeros.
The draws come in BAOAB's order (the velocity, then one per update), so on
one generator the frames are BAOAB's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from jamun_tpu_torch.sampling.mcmc import (
    BAOAB,
    MCMCConfig,
    NeighborCachedScore,
    VerletListScore,
    initialize_velocity,
    make_processed_score_fn,
)

__all__ = ["UnrolledBAOAB"]


@dataclasses.dataclass
class UnrolledBAOAB:
    config: MCMCConfig
    chunk_steps: int = 25

    def __call__(
        self,
        y: torch.Tensor,
        score_fn: Callable,
        generator: torch.Generator,
        v_init: Union[str, torch.Tensor] = "gaussian",
        mask: Optional[torch.Tensor] = None,
        cached_score: Optional[NeighborCachedScore] = None,
    ):
        """The walk from y; `mask` multiplies the velocity and every draw,
        `cached_score` puts the score on the walk's Verlet lists, as in
        `mcmc.BAOAB`. Returns (y, v, y_traj, zeros like y_traj)."""
        cfg = self.config
        if cached_score is not None:
            score_fn = VerletListScore(cached_score, y)
        processed = make_processed_score_fn(score_fn, cfg.inverse_temperature, cfg.score_fn_clip)
        baoab = BAOAB(cfg)
        v = initialize_velocity(v_init, y, cfg.u, generator)
        if mask is not None:
            v = v * mask
        frames = [y]
        for _ in range(max(cfg.steps - 1, 0) // self.chunk_steps):
            carry = (y, v, *processed(y))
            for _ in range(self.chunk_steps):
                R = torch.randn(y.shape, generator=generator, dtype=y.dtype, device=y.device)
                carry = baoab.step(carry, R * mask if mask is not None else R, processed)
                frames.append(carry[0])
            y, v = carry[0], carry[1]
        y_traj = torch.stack(frames)[:: cfg.save_every_n_steps]
        return y, v, y_traj, torch.zeros_like(y_traj)
