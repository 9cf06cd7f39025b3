"""Underdamped Langevin MCMC with the BAOAB and ABOBA splittings.

Counterpart of `jamun_tpu/sampling/mcmc.py:114-322` (dense score). The JAX
walk is one `lax.scan`; here it is a Python loop of steps. Semantics:
  - `steps` runs steps - 1 updates (the reference's `range(1, steps)`);
  - saved frames are the states at absolute steps i with
    i % save_every == 0 and i >= burn_in (the initial state when burn_in == 0);
  - BAOAB evaluates the score once before the loop and carries it across
    steps, so its saved score is the score at the saved state; ABOBA
    evaluates it at each step's midpoint, and saves that.
Every Gaussian draw comes from the caller's `torch.Generator`, and a step
takes its noise `R` as an argument, so a test can feed it numbers.

With a `NeighborCachedScore` (the sparse path's Verlet lists,
`jamun_tpu/sampling/mcmc.py:38-100`) the walk carries (cache, y_ref) in a
`VerletListScore` and rebuilds the list when some atom moved more than the
threshold since the last build. JAX rebuilds under `lax.cond`; reading that
flag on the host here would make every step wait for the forward before it,
so the rebuild is computed on the device at every step and the list and
y_ref are selected with `torch.where` on the device flag: the same
semantics, no host wait.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch

from jamun_tpu_torch.parallel.mesh import randn_graphs
from jamun_tpu_torch.utils.trace import span

__all__ = [
    "MCMCConfig", "BAOAB", "ABOBA", "NeighborCachedScore", "VerletListScore",
    "make_processed_score_fn", "initialize_velocity",
]


@dataclasses.dataclass
class NeighborCachedScore:
    """Verlet-list score of the sparse path: `rebuild(y)` builds the capped
    list within cutoff + skin, `score(y, cache)` evaluates the denoiser's
    score on it (geometry from y, membership from the cache, the true-cutoff
    mask recomputed), and the walk rebuilds when the largest per-atom
    displacement since the last build exceeds `threshold` (skin / 2).
    `rebuilds` is set by the walk: a device tensor counting the rebuilds
    after the first build."""

    rebuild: Callable  # y [G, N, 3] -> cache
    score: Callable  # (y, cache) -> score [G, N, 3]
    threshold: float
    rebuilds: Optional[torch.Tensor] = None


class VerletListScore:
    """The walk's (cache, y_ref) carry around a `NeighborCachedScore`, as a
    score function y -> raw score. Built at the walk's start position; each
    call rebuilds on the device and keeps the new list only where the
    displacement trigger fired (`torch.where` on a device flag: no host
    read)."""

    def __init__(self, cached: NeighborCachedScore, y0: torch.Tensor):
        self.cached = cached
        self.thr2 = float(cached.threshold) ** 2
        self.cache, self.y_ref = tuple(cached.rebuild(y0)), y0
        cached.rebuilds = torch.zeros((), dtype=torch.int64, device=y0.device)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        fire = ((y - self.y_ref) ** 2).sum(-1).max() > self.thr2
        fresh = self.cached.rebuild(y)
        self.cache = tuple(torch.where(fire, f, c) for f, c in zip(fresh, self.cache))
        self.y_ref = torch.where(fire, y, self.y_ref)
        self.cached.rebuilds += fire
        return self.cached.score(y, self.cache)


def make_processed_score_fn(
    score_fn: Callable, inverse_temperature: float = 1.0, score_fn_clip: Optional[float] = None
):
    """processed(y) -> (clipped and scaled score, raw score): clip by
    per-atom norm, then multiply by the inverse temperature."""

    def processed(y):
        orig = score_fn(y)
        score = orig
        if score_fn_clip is not None:
            norm = torch.linalg.vector_norm(score, dim=-1, keepdim=True)
            score = score / torch.clamp(norm, min=1e-20) * torch.clamp(norm, max=score_fn_clip)
        return score * inverse_temperature, orig

    return processed


def initialize_velocity(
    v_init: Union[str, torch.Tensor], y: torch.Tensor, u: float, generator: torch.Generator
) -> torch.Tensor:
    if isinstance(v_init, str):
        if v_init == "gaussian":
            return math.sqrt(u) * randn_graphs(y.shape, generator, y.dtype, y.device)
        if v_init == "zero":
            return torch.zeros_like(y)
        raise ValueError(f"{v_init} not in (gaussian, zero)")
    return v_init


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    delta: float = 1.0
    friction: float = 1.0
    M: float = 1.0  # mass
    steps: int = 128
    save_every_n_steps: int = 1
    burn_in_steps: int = 0
    inverse_temperature: float = 1.0
    score_fn_clip: Optional[float] = None

    @property
    def u(self) -> float:
        return 1.0 / self.M

    @property
    def first_save_step(self) -> int:
        """The smallest multiple of save_every_n_steps that is >= burn_in_steps."""
        s = self.save_every_n_steps
        return ((self.burn_in_steps + s - 1) // s) * s

    @property
    def num_saved_frames(self) -> int:
        total = max(self.steps - 1, 0)
        if self.first_save_step > total:
            return 0
        return 1 + (total - self.first_save_step) // self.save_every_n_steps


class _SplittingSampler:
    """The walk loop shared by BAOAB and ABOBA. A carry is
    (y, v, processed score, raw score)."""

    def __init__(self, config: MCMCConfig):
        self.config = config
        self.damp = math.exp(-config.friction)
        self.zeta2 = math.sqrt(1.0 - math.exp(-2.0 * config.friction))

    def __call__(
        self,
        y: torch.Tensor,
        score_fn: Callable,
        generator: torch.Generator,
        v_init: Union[str, torch.Tensor] = "zero",
        mask: Optional[torch.Tensor] = None,
        cached_score: Optional[NeighborCachedScore] = None,
    ):
        """Run the walk from positions y [..., 3]; mask multiplies the
        velocity and every noise draw (node padding); `cached_score` puts the
        score on Verlet lists carried through the walk (score_fn is then not
        called). Returns (y, v, y_traj, score_traj), trajectories stacked on
        a new axis 0."""
        cfg = self.config
        if cached_score is not None:
            score_fn = VerletListScore(cached_score, y)
        processed = make_processed_score_fn(score_fn, cfg.inverse_temperature, cfg.score_fn_clip)
        total = max(cfg.steps - 1, 0)
        first, every = cfg.first_save_step, cfg.save_every_n_steps
        saved = lambda i: i >= first and (i - first) % every == 0  # noqa: E731
        ys, scores = [], []
        with span("jamun.walk.start"):
            v = initialize_velocity(v_init, y, cfg.u, generator)
            if mask is not None:
                v = v * mask
            carry = self._init_carry(y, v, processed)
            if saved(0):
                ys.append(carry[0])
                scores.append(self._initial_score(carry, processed))
        for i in range(1, total + 1):
            with span("jamun.walk.step"):
                R = randn_graphs(y.shape, generator, y.dtype, y.device)
                carry = self.step(carry, R * mask if mask is not None else R, processed)
                if saved(i):
                    ys.append(carry[0])
                    scores.append(carry[3])
        if ys:
            y_traj, score_traj = torch.stack(ys), torch.stack(scores)
        else:
            y_traj = y.new_zeros((0,) + tuple(y.shape))
            score_traj = y.new_zeros((0,) + tuple(y.shape))
        return carry[0], carry[1], y_traj, score_traj


class BAOAB(_SplittingSampler):
    """BAOAB splitting (Leimkuhler-Matthews section 7.3)."""

    def _init_carry(self, y, v, processed):
        return (y, v, *processed(y))

    def _initial_score(self, carry, processed):
        return carry[3]

    def step(self, carry, R: torch.Tensor, processed):
        """One update; R is the Gaussian draw for the O step."""
        cfg = self.config
        y, v, psi, _ = carry
        d2 = cfg.delta / 2.0
        v = v + cfg.u * d2 * psi  # B
        y = y + d2 * v  # A
        vhat = self.damp * v + self.zeta2 * math.sqrt(cfg.u) * R  # O
        y = y + d2 * vhat  # A
        psi, orig = processed(y)
        v = vhat + d2 * psi  # B
        return (y, v, psi, orig)


class ABOBA(_SplittingSampler):
    """ABOBA splitting: the score is taken at the midpoint of each step, so
    the saved score is not the score at the saved state."""

    def _init_carry(self, y, v, processed):
        return (y, v, None, None)

    def _initial_score(self, carry, processed):
        return processed(carry[0])[1]

    def step(self, carry, R: torch.Tensor, processed):
        """One update; R is the Gaussian draw for the O step."""
        cfg = self.config
        y, v, _, _ = carry
        d2 = cfg.delta / 2.0
        y = y + d2 * v  # A
        psi, orig = processed(y)
        v = v + cfg.u * d2 * psi  # B
        vhat = self.damp * v + self.zeta2 * math.sqrt(cfg.u) * R  # O
        v = vhat + d2 * psi  # B
        y = y + d2 * v  # A
        return (y, v, psi, orig)
