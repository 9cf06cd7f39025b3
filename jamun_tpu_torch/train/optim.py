"""optax's optimizers as torch optimizers: `adam`, `adamw` and `adagrad`
with optax's signatures, defaults and update rules.

The configs name `optax.adam` (and `adamw`, `adagrad`) with `_partial_:
true`; the config resolver maps those names here. A factory returns what
optax's returns in JAX, a rule not yet bound to parameters: a callable
`params -> torch.optim.Optimizer`. A schedule (step -> factor, from
`train/lr_schedules.py`), passed as `schedule=`, scales each update as
chaining `optax.scale_by_schedule` after the rule does
(`jamun_tpu/cmdline/common.py:57-67`): the update of step t (from 0) is
multiplied by schedule(t).

torch's own `Adagrad` and `AdamW` differ from optax's (eps outside the root,
weight decay 1e-2, accumulator from 0), so the updates are written here,
step for step as optax writes them:

  adam:    mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  t += 1
           u = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t) + eps_root) + eps)
  adamw:   the same, then u += weight_decay * p (decoupled)
  adagrad: acc = g^2 + acc (from initial_accumulator_value);
           u = g * rsqrt(acc + eps) where acc > 0, else 0
  then     p = p + schedule(t - 1) * (-lr * u)

A parameter without a gradient gets the update of a zero gradient, as every
leaf does in optax. Step counts are Python ints in the parameter group, so
a step makes no host wait and the state dict loads with `weights_only`.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, List, Optional

import torch

__all__ = ["adam", "adamw", "adagrad", "Adam", "Adagrad"]

_OTHER = "ROADMAP.md queue A, 'Other config targets'"


def _check_learning_rate(learning_rate) -> float:
    if callable(learning_rate):
        raise NotImplementedError(
            "a schedule as the learning rate: pass it as the model's lr_scheduler "
            f"instead ({_OTHER})"
        )
    return float(learning_rate)


def _grads(params: List[torch.Tensor]) -> List[torch.Tensor]:
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


class _OptaxRule(torch.optim.Optimizer):
    def __init__(self, params, defaults: dict, schedule: Optional[Callable[[int], float]]):
        super().__init__(params, dict(defaults, count=0))
        self.schedule = schedule

    def _apply(self, group: dict, params: List[torch.Tensor], updates: List[torch.Tensor]) -> None:
        """p = p + schedule(count) * (-lr * u), then count += 1."""
        torch._foreach_mul_(updates, -group["lr"])
        if self.schedule is not None:
            torch._foreach_mul_(updates, float(self.schedule(group["count"])))
        torch._foreach_add_(params, updates)
        group["count"] += 1


class Adam(_OptaxRule):
    """`optax.adam`, and `optax.adamw` with `weight_decay`."""

    def __init__(
        self, params: Iterable[torch.Tensor], lr: float, b1: float = 0.9, b2: float = 0.999,
        eps: float = 1e-8, eps_root: float = 0.0, weight_decay: float = 0.0,
        schedule: Optional[Callable[[int], float]] = None,
    ):
        super().__init__(
            params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay),
            schedule,
        )

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            t = group["count"] + 1
            updates = torch._foreach_div(mu, 1 - b1**t)
            denom = torch._foreach_div(nu, 1 - b2**t)
            torch._foreach_add_(denom, group["eps_root"])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(updates, denom)
            if group["weight_decay"]:
                torch._foreach_add_(updates, params, alpha=group["weight_decay"])
            self._apply(group, params, updates)


class Adagrad(_OptaxRule):
    """`optax.adagrad`."""

    def __init__(
        self, params: Iterable[torch.Tensor], lr: float, initial_accumulator_value: float = 0.1,
        eps: float = 1e-7, schedule: Optional[Callable[[int], float]] = None,
    ):
        super().__init__(
            params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value, eps=eps),
            schedule,
        )

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            for p in params:
                if not self.state[p]:
                    self.state[p]["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"]
                    )
            acc = [self.state[p]["sum_of_squares"] for p in params]
            torch._foreach_addcmul_(acc, grads, grads)
            inv = torch._foreach_add(acc, group["eps"])
            torch._foreach_rsqrt_(inv)
            updates = [torch.where(a > 0, r, 0.0) * g for a, r, g in zip(acc, inv, grads)]
            self._apply(group, params, updates)


def adam(
    learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
    mu_dtype=None, *, nesterov: bool = False,
):
    """optax.adam's signature and defaults -> `params -> Adam`."""
    if mu_dtype is not None or nesterov:
        raise NotImplementedError(f"adam with mu_dtype or nesterov ({_OTHER})")
    return functools.partial(
        Adam, lr=_check_learning_rate(learning_rate), b1=b1, b2=b2, eps=eps, eps_root=eps_root
    )


def adamw(
    learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
    mu_dtype=None, weight_decay: float = 1e-4, mask=None, *, nesterov: bool = False,
):
    """optax.adamw's signature and defaults (weight decay 1e-4, decoupled)
    -> `params -> Adam`."""
    if mu_dtype is not None or mask is not None or nesterov:
        raise NotImplementedError(f"adamw with mu_dtype, mask or nesterov ({_OTHER})")
    return functools.partial(
        Adam, lr=_check_learning_rate(learning_rate), b1=b1, b2=b2, eps=eps, eps_root=eps_root,
        weight_decay=weight_decay,
    )


def adagrad(learning_rate, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    """optax.adagrad's signature and defaults -> `params -> Adagrad`."""
    return functools.partial(
        Adagrad, lr=_check_learning_rate(learning_rate),
        initial_accumulator_value=initial_accumulator_value, eps=eps,
    )
