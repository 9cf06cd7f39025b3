"""optax's optimizers and schedules as torch optimizers and plain functions,
with optax's signatures, defaults and update rules (optax 0.2.6).

The configs name `optax.adam` (and the others below) with `_partial_:
true`; the config resolver maps those names here. A factory returns what
optax's returns in JAX, a rule not yet bound to parameters: a callable
`params -> torch.optim.Optimizer`, where `params` are tensors or the
(name, tensor) pairs of `module.named_parameters()` (a `mask` needs the
names). A schedule (step -> factor, from `train/lr_schedules.py`), passed
as `schedule=`, scales each update as chaining `optax.scale_by_schedule`
after the rule does (`jamun_tpu/cmdline/common.py:57-67`): the update of
step t (from 0) is multiplied by schedule(t). A `learning_rate` may itself
be a schedule (step -> learning rate, e.g. `warmup_cosine_decay_schedule`
below), read at the step count from 0 as optax's `scale_by_learning_rate`
reads it.

torch's own optimizers differ from optax's (AdamW's decay 1e-2, Adagrad's
eps outside the root and accumulator from 0, RMSprop's eps outside the
root, SGD's momentum dampening), so the updates are written here, step for
step as optax writes them (g the gradient, t the step from 1):

  adam:    mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu
           u = mhat / (sqrt(nu / (1-b2^t) + eps_root) + eps), mhat =
           mu / (1-b1^t), or with nesterov (nadam)
           b1 mu / (1-b1^(t+1)) + (1-b1) g / (1-b1^t);
           mu is kept in `mu_dtype` after the update
  adamw:   adam, then u += weight_decay * p where `mask` allows (nadamw:
           nesterov)
  adagrad: acc = g^2 + acc (from initial_accumulator_value);
           u = g * rsqrt(acc + eps) where acc > 0, else 0
  adamax:  mu as adam; nu = max(|g| + eps, b2 nu); u = mu / (1-b1^t) / nu
  lion:    u = sign((1-b1) g + b1 mu) + weight_decay * p (masked);
           mu = (1-b2) g + b2 mu, kept in `mu_dtype`
  sgd:     u = g; with momentum tr = g + momentum tr (kept in
           `accumulator_dtype`), u = tr, or g + momentum tr (nesterov)
  rmsprop: nu = (1-decay) g^2 + decay nu (from initial_scale), with
           `centered` also mu = (1-decay) g + decay mu; both divided by
           (1-decay^t) with `bias_correction`; u = g * rsqrt(nu - mu^2 + eps)
           (`eps_in_sqrt`) or g / (sqrt(nu - mu^2) + eps); the learning rate
           scales u before the momentum trace, as in optax's chain
  then     p = p + schedule(t - 1) * (-lr(t - 1) * u)  (rmsprop: the trace of
           -lr u)

A parameter without a gradient gets the update of a zero gradient, as every
leaf does in optax. Step counts are Python ints in the parameter group, so
a step makes no host wait and the state dict loads with `weights_only`.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

__all__ = [
    "adam", "adamw", "adagrad", "nadam", "nadamw", "adamax", "lion", "sgd", "rmsprop",
    "Adam", "Adagrad", "Adamax", "Lion", "SGD", "RMSProp", "bind",
    "constant_schedule", "linear_schedule", "cosine_decay_schedule",
    "warmup_cosine_decay_schedule", "exponential_decay",
]


def _dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype, or its name as a config gives it ("bfloat16")."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rpartition(".")[2]
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"mu_dtype={dtype!r} is not a torch dtype")
    return getattr(torch, name)


def _grads(params: List[torch.Tensor]) -> List[torch.Tensor]:
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


def _mask_of(mask, names: Optional[List[str]], params: List[torch.Tensor]) -> Optional[List[bool]]:
    """optax's `mask` (a tree of bools keyed by the flax names, a prefix of
    it, or a callable of the parameter tree that returns one) as one bool
    per parameter. The tree is JAX's parameter tree, {"params": {...}}; a
    tree without the "params" level is read from the level below it."""
    if mask is None:
        return None
    if names is None:
        raise ValueError(
            "a mask is keyed by the parameters' names: bind the optimizer to "
            "module.named_parameters()"
        )
    if callable(mask):
        tree: dict = {}
        for name, p in zip(names, params):
            node = tree.setdefault("params", {})
            *path, leaf = name.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = p
        mask = mask(tree)
    out = []
    for name in names:
        node = mask.get("params", mask) if isinstance(mask, dict) else mask
        for key in name.split("."):
            if not isinstance(node, dict):
                break
            node = node[key]
        out.append(bool(node))
    return out


class _OptaxRule(torch.optim.Optimizer):
    """`learning_rate` a float or a schedule (step -> value); `schedule` a
    multiplier chained after the rule; `mask` for the decoupled decay."""

    def __init__(self, params, defaults: dict, schedule: Optional[Callable[[int], float]],
                 mask=None):
        params = list(params)
        names = None
        if params and isinstance(params[0], tuple):
            names, params = [n for n, _ in params], [p for _, p in params]
        lr = defaults.pop("lr")
        self.lr_schedule = lr if callable(lr) else None
        super().__init__(params, dict(defaults, lr=None if callable(lr) else float(lr), count=0))
        self.schedule = schedule
        self.decay_mask = _mask_of(mask, names, params)

    def _lr(self, group: dict) -> float:
        if self.lr_schedule is not None:
            return float(self.lr_schedule(group["count"]))
        return group["lr"]

    def _decay(self, group: dict, params, updates) -> None:
        """u += weight_decay * p where the mask allows (optax's
        `add_decayed_weights`, masked)."""
        wd = group.get("weight_decay", 0.0)
        if not wd:
            return
        for i, (u, p) in enumerate(zip(updates, params)):
            if self.decay_mask is None or self.decay_mask[i]:
                u.add_(p, alpha=wd)

    def _scale_by_lr(self, group: dict, updates) -> None:
        torch._foreach_mul_(updates, -self._lr(group))

    def _apply(self, group: dict, params: List[torch.Tensor], updates: List[torch.Tensor]) -> None:
        """p = p + schedule(count) * u (u already scaled by -lr), count += 1."""
        if self.schedule is not None:
            torch._foreach_mul_(updates, float(self.schedule(group["count"])))
        torch._foreach_add_(params, updates)
        group["count"] += 1

    def _state(self, params, name: str, make) -> List[torch.Tensor]:
        for p in params:
            if name not in self.state[p]:
                self.state[p][name] = make(p)
        return [self.state[p][name] for p in params]


def _weak(x: float, t: torch.Tensor) -> float:
    """x rounded to t's dtype, as JAX's weak typing rounds a Python scalar
    that multiplies a bf16 array."""
    return float(torch.tensor(x, dtype=t.dtype))


def _moment(grads, moments, decay: float) -> List[torch.Tensor]:
    """(1 - decay) g + decay m, decay m in m's dtype (`_weak`), the sum in
    the promoted dtype."""
    return [(1 - decay) * g + _weak(decay, m) * m for g, m in zip(grads, moments)]


class Adam(_OptaxRule):
    """`optax.adam`, `adamw` with `weight_decay` (and `mask`), `nadam` /
    `nadamw` with `nesterov`; the first moment kept in `mu_dtype`."""

    def __init__(
        self, params: Iterable[torch.Tensor], lr, b1: float = 0.9, b2: float = 0.999,
        eps: float = 1e-8, eps_root: float = 0.0, weight_decay: float = 0.0,
        schedule: Optional[Callable[[int], float]] = None, mu_dtype=None, nesterov: bool = False,
        mask=None,
    ):
        super().__init__(
            params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay,
                         nesterov=nesterov),
            schedule, mask,
        )
        self.mu_dtype = _dtype(mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            mu = self._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
            nu = self._state(params, "nu", torch.zeros_like)
            b1, b2 = group["b1"], group["b2"]
            t = group["count"] + 1
            if self.mu_dtype is None:
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, grads, alpha=1 - b1)
                new_mu = mu
            else:
                new_mu = _moment(grads, mu, b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            if group["nesterov"]:
                updates = torch._foreach_div(new_mu, 1 - b1 ** (t + 1))
                torch._foreach_mul_(updates, b1)
                torch._foreach_add_(
                    updates, torch._foreach_mul(torch._foreach_div(grads, 1 - b1**t), 1 - b1)
                )
            else:
                updates = torch._foreach_div(new_mu, 1 - b1**t)
            denom = torch._foreach_div(nu, 1 - b2**t)
            torch._foreach_add_(denom, group["eps_root"])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(updates, denom)
            if self.mu_dtype is not None:
                for p, m in zip(params, new_mu):
                    self.state[p]["mu"] = m.to(self.mu_dtype)
            self._decay(group, params, updates)
            self._scale_by_lr(group, updates)
            self._apply(group, params, updates)


class Adagrad(_OptaxRule):
    """`optax.adagrad`."""

    def __init__(
        self, params: Iterable[torch.Tensor], lr, initial_accumulator_value: float = 0.1,
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
            acc = self._state(
                params, "sum_of_squares",
                lambda p: torch.full_like(p, group["initial_accumulator_value"]),
            )
            torch._foreach_addcmul_(acc, grads, grads)
            inv = torch._foreach_add(acc, group["eps"])
            torch._foreach_rsqrt_(inv)
            updates = [torch.where(a > 0, r, 0.0) * g for a, r, g in zip(acc, inv, grads)]
            self._scale_by_lr(group, updates)
            self._apply(group, params, updates)


class Adamax(_OptaxRule):
    """`optax.adamax`."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps), schedule)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            mu = self._state(params, "mu", torch.zeros_like)
            nu = self._state(params, "nu", torch.zeros_like)
            b1, b2, t = group["b1"], group["b2"], group["count"] + 1
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            for n, g in zip(nu, grads):
                torch.maximum(g.abs() + group["eps"], b2 * n, out=n)
            updates = torch._foreach_div(mu, 1 - b1**t)
            torch._foreach_div_(updates, nu)
            self._scale_by_lr(group, updates)
            self._apply(group, params, updates)


class Lion(_OptaxRule):
    """`optax.lion`: the sign of the interpolated momentum, decoupled decay
    (`mask`), the momentum kept in `mu_dtype`."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.99, mu_dtype=None,
                 weight_decay: float = 1e-3, mask=None,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay), schedule, mask)
        self.mu_dtype = _dtype(mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            mu = self._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
            b1, b2 = group["b1"], group["b2"]
            updates = [torch.sign(v) for v in _moment(grads, mu, b1)]
            for p, m in zip(params, _moment(grads, mu, b2)):
                self.state[p]["mu"] = m.to(self.mu_dtype or m.dtype)
            self._decay(group, params, updates)
            self._scale_by_lr(group, updates)
            self._apply(group, params, updates)


def _trace(rule: _OptaxRule, group: dict, params, updates, dtype) -> List[torch.Tensor]:
    """optax's `trace`: tr = u + momentum tr (kept in `dtype`); returns tr,
    or u + momentum tr with nesterov."""
    m = group["momentum"]
    tr = rule._state(params, "trace", lambda p: torch.zeros_like(p, dtype=dtype))
    new = [u + _weak(m, t) * t for u, t in zip(updates, tr)]
    out = [u + m * t for u, t in zip(updates, new)] if group["nesterov"] else new
    for p, t in zip(params, new):
        rule.state[p]["trace"] = t.to(dtype or t.dtype, copy=True)  # `out` is scaled in place
    return out


class SGD(_OptaxRule):
    """`optax.sgd`: plain, or with a momentum trace (nesterov), the trace
    kept in `accumulator_dtype`."""

    def __init__(self, params, lr, momentum: Optional[float] = None, nesterov: bool = False,
                 accumulator_dtype=None, schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov), schedule)
        self.accumulator_dtype = _dtype(accumulator_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            updates = [g.clone() for g in _grads(params)]
            if group["momentum"] is not None:
                updates = _trace(self, group, params, updates, self.accumulator_dtype)
            self._scale_by_lr(group, updates)
            self._apply(group, params, updates)


class RMSProp(_OptaxRule):
    """`optax.rmsprop`: plain or `centered`, eps inside or outside the root,
    with `bias_correction`, and a momentum trace after the learning rate."""

    def __init__(self, params, lr, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 bias_correction: bool = False, schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt,
            centered=centered, momentum=momentum, nesterov=nesterov,
            bias_correction=bias_correction,
        ), schedule)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            d, t = group["decay"], group["count"] + 1
            nu = self._state(params, "nu", lambda p: torch.full_like(p, group["initial_scale"]))
            torch._foreach_mul_(nu, d)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - d)
            corr = 1 - d**t if group["bias_correction"] else 1.0
            var = torch._foreach_div(nu, corr)
            if group["centered"]:
                mu = self._state(params, "mu", torch.zeros_like)
                torch._foreach_mul_(mu, d)
                torch._foreach_add_(mu, grads, alpha=1 - d)
                mu_hat = torch._foreach_div(mu, corr)
                torch._foreach_sub_(var, torch._foreach_mul(mu_hat, mu_hat))
            if group["eps_in_sqrt"]:
                torch._foreach_add_(var, group["eps"])
                torch._foreach_rsqrt_(var)
            else:
                torch._foreach_sqrt_(var)
                torch._foreach_add_(var, group["eps"])
                torch._foreach_reciprocal_(var)
            updates = torch._foreach_mul(var, grads)
            self._scale_by_lr(group, updates)
            if group["momentum"] is not None:
                updates = _trace(self, group, params, updates, None)
            self._apply(group, params, updates)


def bind(optimizer: Callable, module: torch.nn.Module) -> torch.optim.Optimizer:
    """A factory bound to `module`'s parameters: a rule of this module gets
    them with their names (a `mask` reads them), any other factory (a
    torch optimizer) the tensors alone."""
    named = list(module.named_parameters())
    func = optimizer.func if isinstance(optimizer, functools.partial) else optimizer
    if isinstance(func, type) and issubclass(func, _OptaxRule):
        return optimizer(named)
    return optimizer([p for _, p in named])


# ---- the factories, optax's signatures and defaults ----


def adam(
    learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
    mu_dtype=None, *, nesterov: bool = False,
):
    """optax.adam -> `params -> Adam`."""
    return functools.partial(
        Adam, lr=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, mu_dtype=mu_dtype,
        nesterov=nesterov,
    )


def adamw(
    learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
    mu_dtype=None, weight_decay: float = 1e-4, mask=None, *, nesterov: bool = False,
):
    """optax.adamw (weight decay 1e-4, decoupled, where `mask` allows) ->
    `params -> Adam`."""
    return functools.partial(
        Adam, lr=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, mu_dtype=mu_dtype,
        nesterov=nesterov, weight_decay=weight_decay, mask=mask,
    )


def nadam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, mu_dtype=None, *, nesterov: bool = True):
    """optax.nadam: adam with Nesterov momentum."""
    return adam(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)


def nadamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           eps_root: float = 0.0, mu_dtype=None, weight_decay: float = 1e-4, mask=None, *,
           nesterov: bool = True):
    """optax.nadamw: adamw with Nesterov momentum."""
    return adamw(learning_rate, b1, b2, eps, eps_root, mu_dtype, weight_decay, mask,
                 nesterov=nesterov)


def adagrad(learning_rate, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    """optax.adagrad -> `params -> Adagrad`."""
    return functools.partial(
        Adagrad, lr=learning_rate, initial_accumulator_value=initial_accumulator_value, eps=eps,
    )


def adamax(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax.adamax -> `params -> Adamax`."""
    return functools.partial(Adamax, lr=learning_rate, b1=b1, b2=b2, eps=eps)


def lion(learning_rate, b1: float = 0.9, b2: float = 0.99, mu_dtype=None,
         weight_decay: float = 1e-3, mask=None):
    """optax.lion -> `params -> Lion`."""
    return functools.partial(Lion, lr=learning_rate, b1=b1, b2=b2, mu_dtype=mu_dtype,
                             weight_decay=weight_decay, mask=mask)


def sgd(learning_rate, momentum: Optional[float] = None, nesterov: bool = False,
        accumulator_dtype=None):
    """optax.sgd -> `params -> SGD`."""
    return functools.partial(SGD, lr=learning_rate, momentum=momentum, nesterov=nesterov,
                             accumulator_dtype=accumulator_dtype)


def rmsprop(learning_rate, decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0,
            eps_in_sqrt: bool = True, centered: bool = False, momentum: Optional[float] = None,
            nesterov: bool = False, bias_correction: bool = False):
    """optax.rmsprop -> `params -> RMSProp`."""
    return functools.partial(
        RMSProp, lr=learning_rate, decay=decay, eps=eps, initial_scale=initial_scale,
        eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum, nesterov=nesterov,
        bias_correction=bias_correction,
    )


# ---- optax's schedules: step -> value, in f32 as JAX computes them ----

_f32 = np.float32


def constant_schedule(value):
    """optax.constant_schedule."""
    return lambda count: value


def linear_schedule(init_value, end_value, transition_steps: int, transition_begin: int = 0):
    """optax.linear_schedule (polynomial of power 1)."""
    if transition_steps <= 0:
        return lambda count: init_value
    begin = max(transition_begin, 0)

    def schedule(count):
        c = _f32(np.clip(count - begin, 0, transition_steps))
        frac = _f32(1) - c / _f32(transition_steps)
        return float(_f32(init_value - end_value) * frac + _f32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0):
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = _f32(min(count, decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(decay_steps)))
        decayed = _f32(1 - alpha) * cosine ** _f32(exponent) + _f32(alpha)
        return float(_f32(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0, exponent: float = 1.0):
    """optax.warmup_cosine_decay_schedule: linear warm-up to `peak_value`,
    then cosine decay to `end_value` at `decay_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      transition_begin: int = 0, staircase: bool = False,
                      end_value: Optional[float] = None):
    """optax.exponential_decay."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    begin = max(transition_begin, 0)

    def schedule(count):
        dc = count - begin
        p = _f32(dc) / _f32(transition_steps)
        if staircase:
            p = np.floor(p)
        value = _f32(init_value) if dc <= 0 else _f32(init_value) * np.power(_f32(decay_rate), p)
        if end_value is not None:
            value = (max if decay_rate < 1.0 else min)(value, _f32(end_value))
        return float(value)

    return schedule
