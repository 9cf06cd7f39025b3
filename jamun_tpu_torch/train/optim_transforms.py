"""optax's transforms as rules, and its combinators (optax 0.2.6).

JAX's trainer runs whatever `model.optim` builds: a bare transform too
(`optax.scale_by_adam`, `optax.clip_by_global_norm`, ...), whose update
`optax.apply_updates` adds to the parameters as it is (no learning rate, no
sign flip), and the combinators that compose rules: `masked`,
`multi_transform` / `partition`, `freeze`, `selective_transform`,
`flatten`, `apply_every`, `conditionally_transform` / `conditionally_mask`,
`with_extra_args_support`, `inject_hyperparams`. Each factory here returns
what its optax namesake returns in JAX, a rule not yet bound to parameters
(`params -> torch optimizer`), built on the transform layer of
`train/optim.py`: a bare transform is a `_Chain` of its one `_Step`, a
combinator a node over the rules inside it, which keep their state in its
storage under a prefix (`optim._attach`).

Masks and labels are trees keyed by the flax names (`optim.bind`), a prefix
of one, or a callable of the parameter tree, as optax takes them. A leaf
`masked` leaves out takes the incoming update as it is: as `model.optim`
alone it ascends the raw gradient, as optax's does.

Steps that read a whole leaf (norms, means, centring, unit-wise clipping)
read flax's leaves: a scanned E3Conv's layer slices stacked as one.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, List, Optional

import numpy as np
import torch

from jamun_tpu_torch.train import optim
from jamun_tpu_torch.train.optim import (
    _bias,
    _Chain,
    _Combinator,
    _Count,
    _Custom,
    _dtype,
    _Group,
    _Leaf,
    _leaf_norms,
    _Param,
    _per_param,
    _put_leaf,
    _Scope,
    _select,
    _sq_norm,
    _stacked,
    _Step,
    _tree_values,
    _Unused,
    _value,
    _vdot,
)

# optax's transforms given as `model.optim` (bare), by name
TRANSFORMS = (
    "scale", "scale_by_adam", "scale_by_adadelta", "scale_by_adamax", "scale_by_adan",
    "scale_by_amsgrad", "scale_by_belief", "scale_by_distance_over_gradients",
    "scale_by_factored_rms", "scale_by_lbfgs", "scale_by_learning_rate", "scale_by_lion",
    "scale_by_novograd", "scale_by_optimistic_gradient", "scale_by_param_block_norm",
    "scale_by_param_block_rms", "scale_by_radam", "scale_by_rms", "scale_by_rprop",
    "scale_by_rss", "scale_by_schedule", "scale_by_sign", "scale_by_sm3", "scale_by_stddev",
    "scale_by_trust_ratio", "scale_by_yogi", "add_decayed_weights", "add_noise",
    "adaptive_grad_clip", "centralize", "clip", "clip_by_block_rms", "clip_by_global_norm",
    "ema", "identity", "keep_params_nonnegative", "normalize_by_update_norm", "set_to_zero",
    "trace", "zero_nans", "apply_every", "snapshot", "stateless", "stateless_with_tree_map",
)
COMBINATORS = (
    "masked", "multi_transform", "partition", "freeze", "selective_transform", "flatten",
    "conditionally_transform", "conditionally_mask", "with_extra_args_support",
    "inject_hyperparams", "inject_stateful_hyperparams",
)
# functions a config passes to a transform (MultiSteps' skips, snapshot's measure)
FUNCTIONS = ("skip_not_finite", "skip_large_updates", "global_norm")

__all__ = [*TRANSFORMS, *COMBINATORS, *FUNCTIONS]


def _bare(alias: str, make_step: Callable, lr=None):
    """A transform alone as a rule: its state is its step's."""
    return functools.partial(_Chain, make_steps=lambda: [make_step()], lr=lr, alias=alias,
                             bare=True)


def global_norm(updates: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm of a list of tensors."""
    return _sq_norm(updates).sqrt()


def _by_leaf(rule, tensors: List[torch.Tensor], fn: Callable) -> List[torch.Tensor]:
    """fn on each flax leaf (a scanned leaf's slices stacked), split back
    into the parameters."""
    out = [None] * len(tensors)
    for idx in rule._leaves():
        y = fn(_stacked(tensors, idx))
        for k, i in enumerate(idx):
            out[i] = y if len(idx) == 1 else y[k]
    return out


def _flag(cond, like: torch.Tensor):
    """A host or device bool as a multiplier of `like`'s dtype."""
    return cond.to(like.dtype) if torch.is_tensor(cond) else float(bool(cond))


# ---- the steps optax's rules do not already give ----


class _ScaleByRms(_Step):
    """optax.scale_by_rms: nu = (1-decay) g^2 + decay nu (from
    `initial_scale`), bias-corrected with `bias_correction`; u = g *
    rsqrt(nu + eps), or g / (sqrt(nu) + eps)."""

    def __init__(self, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                 bias_correction=False):
        self.decay, self.eps, self.init = decay, eps, initial_scale
        self.eps_in_sqrt, self.bias_correction = eps_in_sqrt, bias_correction

    def layout(self, rule) -> dict:
        nu = {"nu": _Param("nu")}
        return {"count": _Count(), **nu} if self.bias_correction else nu

    def scaling(self, group, nu, mu=None):
        hat = (torch._foreach_div(nu, _bias(self.decay, group["count"] + 1))
               if self.bias_correction else optim._copy(nu))
        if mu is not None:
            mu_hat = (torch._foreach_div(mu, _bias(self.decay, group["count"] + 1))
                      if self.bias_correction else mu)
            torch._foreach_sub_(hat, torch._foreach_mul(mu_hat, mu_hat))
        if self.eps_in_sqrt:
            torch._foreach_add_(hat, self.eps)
            torch._foreach_rsqrt_(hat)
        else:
            torch._foreach_sqrt_(hat)
            torch._foreach_add_(hat, self.eps)
            torch._foreach_reciprocal_(hat)
        return hat

    def __call__(self, rule, group, params, updates):
        nu = rule._state(params, "nu", lambda p: torch.full_like(p, self.init))
        optim._ema_sq_(nu, updates, self.decay)
        return torch._foreach_mul(self.scaling(group, nu), updates)


class _ScaleByStddev(_ScaleByRms):
    """optax.scale_by_stddev: as scale_by_rms with nu - mu^2."""

    def layout(self, rule) -> dict:
        mn = {"mu": _Param("mu"), "nu": _Param("nu")}
        return {"count": _Count(), **mn} if self.bias_correction else mn

    def __call__(self, rule, group, params, updates):
        mu = rule._state(params, "mu", torch.zeros_like)
        nu = rule._state(params, "nu", lambda p: torch.full_like(p, self.init))
        optim._ema_(mu, updates, self.decay)
        optim._ema_sq_(nu, updates, self.decay)
        return torch._foreach_mul(self.scaling(group, nu, mu), updates)


class _ScaleByRss(_Step):
    """optax.scale_by_rss: acc = g^2 + acc (from
    `initial_accumulator_value`); u = g rsqrt(acc + eps) where acc > 0."""

    def __init__(self, initial_accumulator_value=0.1, eps=1e-7):
        self.init, self.eps = initial_accumulator_value, eps

    def layout(self, rule) -> dict:
        return {"sum_of_squares": _Param("sum_of_squares")}

    def __call__(self, rule, group, params, updates):
        acc = rule._state(params, "sum_of_squares", lambda p: torch.full_like(p, self.init))
        torch._foreach_addcmul_(acc, updates, updates)
        inv = torch._foreach_add(acc, self.eps)
        torch._foreach_rsqrt_(inv)
        return [torch.where(a > 0, r, 0.0) * g for a, r, g in zip(acc, inv, updates)]


class _ScaleByLion(_Step):
    """optax.scale_by_lion: sign((1-b1) g + b1 mu); mu = (1-b2) g + b2 mu,
    kept in `mu_dtype`."""

    def __init__(self, b1=0.9, b2=0.99, mu_dtype=None):
        self.b1, self.b2, self.mu_dtype = b1, b2, _dtype(mu_dtype)

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu")}

    def __call__(self, rule, group, params, updates):
        mu = rule._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
        out = [torch.sign(v) for v in optim._moment(updates, mu, self.b1)]
        for p, m in zip(params, optim._moment(updates, mu, self.b2)):
            rule.state[p]["mu"] = m.to(self.mu_dtype or m.dtype)
        return out


class _ScaleBySchedule(_Step):
    """optax.scale_by_schedule: u * step_size_fn(count)."""

    def __init__(self, step_size_fn):
        self.fn = step_size_fn

    def layout(self, rule) -> dict:
        return {"count": _Count()}

    def __call__(self, rule, group, params, updates):
        torch._foreach_mul_(updates, _value(self.fn(group["count"])))
        return updates


class _Identity(_Step):
    """optax.identity (and `with_extra_args_support`'s pass-through)."""

    def __call__(self, rule, group, params, updates):
        return updates


class _Snapshot(_Step):
    """optax.snapshot: the update unchanged; the measurement it keeps in
    optax's state is not carried (nothing reads it)."""

    def layout(self, rule) -> dict:
        return {"measurement": _Unused()}

    def __call__(self, rule, group, params, updates):
        return updates


class _SetToZero(_Step):
    """optax.set_to_zero."""

    def __call__(self, rule, group, params, updates):
        return [torch.zeros_like(u) for u in updates]


class _Clip(_Step):
    """optax.clip: each entry to [-max_delta, max_delta]."""

    def __init__(self, max_delta):
        self.max_delta = max_delta

    def __call__(self, rule, group, params, updates):
        torch._foreach_clamp_min_(updates, -self.max_delta)
        torch._foreach_clamp_max_(updates, self.max_delta)
        return updates


class _ClipByGlobalNorm(_Step):
    """optax.clip_by_global_norm: u / |u| * max_norm where the global norm
    |u| is not below `max_norm` (`torch.where` on the device)."""

    def __init__(self, max_norm):
        self.max_norm = max_norm

    def __call__(self, rule, group, params, updates):
        norm = _sq_norm(updates).sqrt()
        keep = norm < self.max_norm
        return [torch.where(keep, u, u / norm * self.max_norm) for u in updates]


class _NormalizeByUpdateNorm(_Step):
    """optax.normalize_by_update_norm: u / ((|u| + eps) / scale_factor)."""

    def __init__(self, scale_factor=1.0, eps=1e-6):
        self.scale_factor, self.eps = scale_factor, eps

    def __call__(self, rule, group, params, updates):
        norm = (_sq_norm(updates).sqrt() + self.eps) / self.scale_factor
        return [u / norm for u in updates]


class _Normalize(_Step):
    """optax.contrib.normalize: u / |u| (the global norm)."""

    def __call__(self, rule, group, params, updates):
        norm = _sq_norm(updates).sqrt()
        return [u / norm for u in updates]


class _Centralize(_Step):
    """optax.centralize: each flax leaf of more than one axis less its mean
    over the axes after the first."""

    def __call__(self, rule, group, params, updates):
        return _by_leaf(rule, updates, lambda g: g - g.mean(dim=tuple(range(1, g.ndim)),
                                                            keepdim=True) if g.ndim > 1 else g)


class _AdaptiveGradClip(_Step):
    """optax.adaptive_grad_clip: each flax leaf's unit-wise norms of the
    update and the parameter; where the update's reaches clipping *
    max(|p|, eps) it is scaled down to it."""

    def __init__(self, clipping, eps=1e-3, axis=None):
        self.clipping, self.eps, self.axis = clipping, eps, axis

    def unitwise_norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis is not None:
            axis = self.axis if isinstance(self.axis, int) else tuple(self.axis)
            sq = (x * x).sum(dim=axis, keepdim=True)
        elif x.squeeze().ndim <= 1:
            sq = (x * x).sum().reshape([1] * x.ndim)
        elif x.ndim in (2, 3):
            sq = (x * x).sum(dim=0, keepdim=True)
        elif x.ndim == 4:
            sq = (x * x).sum(dim=(0, 1, 2), keepdim=True)
        else:
            raise ValueError(f"Expected parameter with shape in (1, 2, 3, 4), got {tuple(x.shape)}. "
                             "Use axis parameter to specify reduction axes for other shapes.")
        return torch.sqrt(sq).expand(x.shape)

    def __call__(self, rule, group, params, updates):
        out = [None] * len(updates)
        for idx in rule._leaves():
            g, p = _stacked(updates, idx), _stacked(params, idx)
            g_norm = self.unitwise_norm(g)
            max_norm = self.clipping * torch.clamp_min(self.unitwise_norm(p), self.eps)
            clipped = g * (max_norm / torch.clamp_min(g_norm, 1e-6))
            y = torch.where(g_norm < max_norm, g, clipped)
            for k, i in enumerate(idx):
                out[i] = y if len(idx) == 1 else y[k]
        return out


class _ZeroNans(_Step):
    """optax.zero_nans: NaN entries to 0 (its flags, which nothing reads,
    are not carried)."""

    def layout(self, rule) -> dict:
        return {"found_nan": _Unused()}

    def __call__(self, rule, group, params, updates):
        return [torch.where(torch.isnan(u), 0.0, u) for u in updates]


class _KeepParamsNonnegative(_Step):
    """optax.keep_params_nonnegative: -p where p + u < 0."""

    def __call__(self, rule, group, params, updates):
        return [torch.where(p + u < 0.0, -p, u) for p, u in zip(params, updates)]


class _ParamBlockNorm(_Step):
    """optax.scale_by_param_block_norm: each flax leaf times max(|p|,
    min_scale)."""

    def __init__(self, min_scale=1e-3):
        self.min_scale = min_scale

    def __call__(self, rule, group, params, updates):
        norms = torch.clamp_min(torch.stack(_leaf_norms(rule, params)), self.min_scale)
        torch._foreach_mul_(updates, _per_param(rule, norms))
        return updates


class _DistanceOverGradients(_Step):
    """optax.scale_by_distance_over_gradients: per flax leaf, the largest
    distance from the first parameters (from reps_rel (1 + |p0|)) and the
    summed squared gradients, combined as optax 0.2.6 combines them (its
    arguments out of order, below)."""

    def __init__(self, reps_rel=1e-6, eps=1e-8, param_dtype="float32", global_scale=1.0):
        self.reps_rel, self.eps, self.global_scale = reps_rel, eps, global_scale
        self.param_dtype = _dtype(param_dtype)

    def layout(self, rule) -> dict:
        return {"max_dist": _Leaf(lambda r, leaf, v: _put_leaf(r, leaf, "max_dist", v.reshape(()))),
                "grad_sum_of_squares": _Leaf(
                    lambda r, leaf, v: _put_leaf(r, leaf, "grad_sum_of_squares", v.reshape(()))),
                "init_params": _Param("init_params")}

    def __call__(self, rule, group, params, updates):
        heads = [params[idx[0]] for idx in rule._leaves()]
        first = ({} if "max_dist" in rule.state[heads[0]]
                 else {id(h): n for h, n in zip(heads, _leaf_norms(rule, params))})
        d = torch.stack(rule._state(heads, "max_dist",
                                    lambda h: self.reps_rel * (1 + first[id(h)])))
        sos = torch.stack(rule._state(heads, "grad_sum_of_squares", lambda h: torch.zeros(
            (), dtype=h.dtype, device=h.device)))
        p0 = rule._state(params, "init_params", lambda p: p.detach().to(self.param_dtype, copy=True))
        dist = torch.stack(_leaf_norms(rule, torch._foreach_sub(params, p0)))
        d = torch.maximum(d, dist)
        sos = sos + torch.stack(_leaf_norms(rule, updates)).square()
        for h, a, b in zip(heads, d.unbind(), sos.unbind()):
            rule.state[h]["max_dist"], rule.state[h]["grad_sum_of_squares"] = a, b
        # optax 0.2.6 maps its `_tx(g, d, g_sos)` over (max_dist, g_sos,
        # updates): the update is global_scale * g_sos / sqrt(u + eps) *
        # max_dist, NaN where u < -eps. Kept, as the port keeps optax's quirks.
        per_d, per_sos = _per_param(rule, d), _per_param(rule, sos)
        return [self.global_scale * (s / torch.sqrt(u + self.eps)) * m
                for u, m, s in zip(updates, per_d, per_sos)]


def _put_memory(key: str):
    """lbfgs' memory of a flax leaf, [m, *leaf]: each slice of a scanned
    leaf its [m, *slice]."""
    def put(rule, leaf: int, value: torch.Tensor) -> None:
        params = rule.param_groups[0]["params"]
        idx = rule._leaves()[leaf]
        for k, i in enumerate(idx):
            rule.state[params[i]][key] = (value if len(idx) == 1 else value[:, k]).to(
                params[i].device).clone()
    return _Leaf(put)


class _ScaleByLBFGS(_Step):
    """optax.scale_by_lbfgs: the two-loop recursion over a memory of
    `memory_size` pairs of parameter and update differences (no loss
    needed). The memory's slot is the count mod `memory_size`: Python ints
    on a host count, `index_select` / `index_copy` on a device one."""

    def __init__(self, memory_size=10, scale_init_precond=True):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m, self.scale_init = memory_size, scale_init_precond

    def layout(self, rule) -> dict:
        return {"count": _Count(), "params": _Param("lbfgs_params"),
                "updates": _Param("lbfgs_updates"),
                "diff_params_memory": _put_memory("diff_params_memory"),
                "diff_updates_memory": _put_memory("diff_updates_memory"),
                "weights_memory": _Custom(self.put_weights)}

    @staticmethod
    def put_weights(rule, value: torch.Tensor) -> None:
        """One vector for the whole tree, on the first parameter."""
        p = rule.param_groups[0]["params"][0]
        rule.state[p]["weights_memory"] = value.to(p.device, p.dtype).clone()

    def __call__(self, rule, group, params, updates):
        m, count = self.m, group["count"]
        mem = lambda p: torch.zeros((m, *p.shape), dtype=p.dtype, device=p.device)  # noqa: E731
        prev_p = rule._state(params, "lbfgs_params", torch.zeros_like)
        prev_u = rule._state(params, "lbfgs_updates", torch.zeros_like)
        dp_mem = rule._state(params, "diff_params_memory", mem)
        du_mem = rule._state(params, "diff_updates_memory", mem)
        head = params[0]
        rho = rule._state([head], "weights_memory", lambda p: torch.zeros(
            m, dtype=p.dtype, device=p.device))[0]
        started = count > 0
        dp = torch._foreach_sub(params, prev_p)
        du = torch._foreach_sub(updates, prev_u)
        vd = _vdot(du, dp)
        weight = torch.where(vd == 0.0, 0.0, 1.0 / vd)
        if torch.is_tensor(started):
            dp = [torch.where(started, x, 0.0) for x in dp]
            du = [torch.where(started, x, 0.0) for x in du]
            weight = torch.where(started, weight, 0.0)
        elif not started:
            dp, du = [torch.zeros_like(x) for x in dp], [torch.zeros_like(x) for x in du]
            weight = torch.zeros_like(weight)
        slot = (count - 1) % m
        dp_mem = [self.set(x, slot, y) for x, y in zip(dp_mem, dp)]
        du_mem = [self.set(x, slot, y) for x, y in zip(du_mem, du)]
        rho = self.set(rho, slot, weight)
        if self.scale_init:
            den = _sq_norm(du)
            scale = torch.where(den > 0.0, _vdot(du, dp) / den, 1.0)
            capped = torch.clamp_max(1.0 / _sq_norm(updates).sqrt(), 1.0)
            scale = torch.where(started, scale, capped) if torch.is_tensor(started) else (
                scale if started else capped)
        else:
            scale = 1.0
        order = [(count + i) % m for i in range(m)]
        vec, alphas = list(updates), []
        for i in reversed(order):
            dw_i, du_i = [self.get(x, i) for x in dp_mem], [self.get(x, i) for x in du_mem]
            alpha = self.get(rho, i) * _vdot(dw_i, vec)
            vec = [v - alpha * u for v, u in zip(vec, du_i)]
            alphas.append(alpha)
        vec = [v * scale for v in vec]
        for i, alpha in zip(order, reversed(alphas)):
            dw_i, du_i = [self.get(x, i) for x in dp_mem], [self.get(x, i) for x in du_mem]
            beta = self.get(rho, i) * _vdot(du_i, vec)
            vec = [v + (alpha - beta) * w for v, w in zip(vec, dw_i)]
        for p, a, b, x, y in zip(params, dp_mem, du_mem, params, updates):
            rule.state[p]["diff_params_memory"], rule.state[p]["diff_updates_memory"] = a, b
            rule.state[p]["lbfgs_params"] = x.detach().clone()
            rule.state[p]["lbfgs_updates"] = y.clone()
        rule.state[head]["weights_memory"] = rho
        return vec

    @staticmethod
    def set(memory: torch.Tensor, slot, value: torch.Tensor) -> torch.Tensor:
        if torch.is_tensor(slot):
            return memory.index_copy(0, slot.reshape(1).long(), value.unsqueeze(0))
        out = memory.clone()
        out[slot] = value
        return out

    @staticmethod
    def get(memory: torch.Tensor, slot) -> torch.Tensor:
        if torch.is_tensor(slot):
            return memory.index_select(0, slot.reshape(1).long())[0]
        return memory[slot]


class _ApplyEvery(_Step):
    """optax.apply_every: the updates of k steps summed, emitted on the
    k-th, zero on the others (the count mod k decides: a host int, or
    device arithmetic)."""

    def __init__(self, k=1):
        self.k = k

    def layout(self, rule) -> dict:
        return {"count": _Count(mod=self.k), "grad_acc": _Param("grad_acc")}

    def __call__(self, rule, group, params, updates):
        c = group["count"] % self.k
        acc = rule._state(params, "grad_acc", torch.zeros_like)
        keep = _flag(c != 0, updates[0])
        new = [keep * a + g for a, g in zip(acc, updates)]
        for p, a in zip(params, new):
            rule.state[p]["grad_acc"] = a
        emit = _flag(c == self.k - 1, updates[0])
        return [emit * a for a in new]


class _Stateless(_Step):
    """optax.stateless: f(updates, params) on JAX's trees, the trees built
    of the flax leaves (a scanned leaf stacked) under "params"; with
    `tree_map`, f(u, p) on each leaf."""

    def __init__(self, f, tree_map: bool):
        self.f, self.tree_map = f, tree_map

    def __call__(self, rule, group, params, updates):
        if self.tree_map:
            out = [None] * len(updates)
            for idx in rule._leaves():
                y = self.f(_stacked(updates, idx), _stacked(params, idx))
                for k, i in enumerate(idx):
                    out[i] = y if len(idx) == 1 else y[k]
            return out
        names = rule.leaf_names()

        def tree(tensors):
            built: dict = {}
            for name, idx in zip(names, rule._leaves()):
                node = built.setdefault("params", {})
                *path, leaf = name.split(".")
                for key in path:
                    node = node.setdefault(key, {})
                node[leaf] = _stacked(tensors, idx)
            return built

        result = self.f(tree(updates), tree(params))
        out = [None] * len(updates)
        for name, idx in zip(names, rule._leaves()):
            node = result["params"]
            for key in name.split("."):
                node = node[key]
            for k, i in enumerate(idx):
                out[i] = node if len(idx) == 1 else node[k]
        return out


# ---- bare transforms: optax's signatures and defaults ----


def scale(step_size: float):
    """optax.scale."""
    return _bare("scale", lambda: optim._Scale(step_size))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                  mu_dtype=None, *, nesterov: bool = False):
    """optax.scale_by_adam."""
    return _bare("scale_by_adam", lambda: optim._ScaleByAdam(b1, b2, eps, eps_root, mu_dtype,
                                                             nesterov))


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6):
    """optax.scale_by_adadelta."""
    return _bare("scale_by_adadelta", lambda: optim._ScaleByAdadelta(rho, eps))


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax.scale_by_adamax."""
    return _bare("scale_by_adamax", lambda: optim._ScaleByAdamax(b1, b2, eps))


def scale_by_adan(b1: float = 0.98, b2: float = 0.92, b3: float = 0.99, eps: float = 1e-8,
                  eps_root: float = 0.0):
    """optax.scale_by_adan."""
    return _bare("scale_by_adan", lambda: optim._ScaleByAdan(b1, b2, b3, eps, eps_root))


def scale_by_amsgrad(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     eps_root: float = 0.0, mu_dtype=None):
    """optax.scale_by_amsgrad."""
    return _bare("scale_by_amsgrad", lambda: optim._ScaleByAmsgrad(b1, b2, eps, eps_root,
                                                                   mu_dtype))


def scale_by_belief(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
                    eps_root: float = 1e-16, *, nesterov: bool = False):
    """optax.scale_by_belief."""
    return _bare("scale_by_belief", lambda: optim._ScaleByBelief(b1, b2, eps, eps_root, nesterov))


def scale_by_distance_over_gradients(reps_rel=1e-6, eps=1e-8, param_dtype="float32",
                                     global_scale=1.0):
    """optax.scale_by_distance_over_gradients."""
    return _bare("scale_by_distance_over_gradients", lambda: _DistanceOverGradients(
        reps_rel, eps, param_dtype, global_scale))


def scale_by_factored_rms(factored: bool = True, decay_rate: float = 0.8, step_offset: int = 0,
                          min_dim_size_to_factor: int = 128, epsilon: float = 1e-30):
    """optax.scale_by_factored_rms (its default `decay_rate_fn`)."""
    return _bare("scale_by_factored_rms", lambda: optim._FactoredRMS(
        factored, decay_rate, step_offset, min_dim_size_to_factor, epsilon))


def scale_by_lbfgs(memory_size: int = 10, scale_init_precond: bool = True):
    """optax.scale_by_lbfgs."""
    return _bare("scale_by_lbfgs", lambda: _ScaleByLBFGS(memory_size, scale_init_precond))


def scale_by_learning_rate(learning_rate=None, *, flip_sign: bool = True):
    """optax.scale_by_learning_rate (None: the identity)."""
    return _bare("scale_by_learning_rate", lambda: optim._ScaleByLR(learning_rate, flip_sign))


def scale_by_lion(b1: float = 0.9, b2: float = 0.99, mu_dtype=None):
    """optax.scale_by_lion."""
    return _bare("scale_by_lion", lambda: _ScaleByLion(b1, b2, mu_dtype))


def scale_by_novograd(b1: float = 0.9, b2: float = 0.25, eps: float = 1e-8,
                      eps_root: float = 0.0, weight_decay: float = 0.0, mu_dtype=None):
    """optax.scale_by_novograd (`mu_dtype` None: the parameters')."""
    if mu_dtype is not None:
        raise NotImplementedError(f"scale_by_novograd's mu_dtype is not ported ({optim._OTHER})")
    return _bare("scale_by_novograd", lambda: optim._ScaleByNovograd(b1, b2, eps, eps_root,
                                                                     weight_decay))


def scale_by_optimistic_gradient(alpha: float = 1.0, beta: float = 1.0):
    """optax.scale_by_optimistic_gradient."""
    return _bare("scale_by_optimistic_gradient", lambda: optim._OptimisticGradient(alpha, beta))


def scale_by_param_block_norm(min_scale: float = 1e-3):
    """optax.scale_by_param_block_norm."""
    return _bare("scale_by_param_block_norm", lambda: _ParamBlockNorm(min_scale))


def scale_by_param_block_rms(min_scale: float = 1e-3):
    """optax.scale_by_param_block_rms."""
    return _bare("scale_by_param_block_rms", lambda: optim._ParamBlockRMS(min_scale))


def scale_by_radam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                   threshold: float = 5.0, *, nesterov: bool = False):
    """optax.scale_by_radam."""
    return _bare("scale_by_radam", lambda: optim._ScaleByRAdam(b1, b2, eps, eps_root, threshold,
                                                               nesterov))


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0,
                 eps_in_sqrt: bool = True, bias_correction: bool = False):
    """optax.scale_by_rms."""
    return _bare("scale_by_rms", lambda: _ScaleByRms(decay, eps, initial_scale, eps_in_sqrt,
                                                     bias_correction))


def scale_by_rprop(learning_rate: float, eta_minus: float = 0.5, eta_plus: float = 1.2,
                   min_step_size: float = 1e-6, max_step_size: float = 50.0):
    """optax.scale_by_rprop."""
    return _bare("scale_by_rprop", lambda: optim._ScaleByRprop(
        learning_rate, eta_minus, eta_plus, min_step_size, max_step_size))


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    """optax.scale_by_rss."""
    return _bare("scale_by_rss", lambda: _ScaleByRss(initial_accumulator_value, eps))


def scale_by_schedule(step_size_fn):
    """optax.scale_by_schedule."""
    return _bare("scale_by_schedule", lambda: _ScaleBySchedule(step_size_fn))


def scale_by_sign():
    """optax.scale_by_sign."""
    return _bare("scale_by_sign", optim._Sign)


def scale_by_sm3(b1: float = 0.9, b2: float = 1.0, eps: float = 1e-8):
    """optax.scale_by_sm3."""
    return _bare("scale_by_sm3", lambda: optim._ScaleBySM3(b1, b2, eps))


def scale_by_stddev(decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0,
                    eps_in_sqrt: bool = True, bias_correction: bool = False):
    """optax.scale_by_stddev."""
    return _bare("scale_by_stddev", lambda: _ScaleByStddev(decay, eps, initial_scale, eps_in_sqrt,
                                                           bias_correction))


def scale_by_trust_ratio(min_norm: float = 0.0, trust_coefficient: float = 1.0, eps: float = 0.0):
    """optax.scale_by_trust_ratio."""
    return _bare("scale_by_trust_ratio", lambda: optim._TrustRatio(min_norm, trust_coefficient,
                                                                   eps))


def scale_by_yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3, eps_root: float = 0.0,
                  initial_accumulator_value: float = 1e-6):
    """optax.scale_by_yogi."""
    return _bare("scale_by_yogi", lambda: optim._ScaleByYogi(b1, b2, eps, eps_root,
                                                             initial_accumulator_value))


def add_decayed_weights(weight_decay=0.0, mask=None):
    """optax.add_decayed_weights."""
    return _bare("add_decayed_weights", lambda: optim._AddDecayedWeights(weight_decay, mask))


def add_noise(eta: float, gamma: float, key=None, *, seed: Optional[int] = None):
    """optax.add_noise; `key` (an int here) or `seed` seeds the port's
    torch generator (0 by default, as optax's key): a JAX key cannot seed
    it, so the stream is not optax's."""
    if key is not None and seed is not None:
        raise ValueError("Only one of seed or key can be specified.")
    seed = int(key if key is not None else seed or 0)
    return _bare("add_noise", lambda: optim._AddNoise(eta, gamma, seed))


def adaptive_grad_clip(clipping: float, eps: float = 1e-3, axis=None):
    """optax.adaptive_grad_clip."""
    return _bare("adaptive_grad_clip", lambda: _AdaptiveGradClip(clipping, eps, axis))


def centralize():
    """optax.centralize."""
    return _bare("centralize", _Centralize)


def clip(max_delta):
    """optax.clip."""
    return _bare("clip", lambda: _Clip(max_delta))


def clip_by_block_rms(threshold: float):
    """optax.clip_by_block_rms."""
    return _bare("clip_by_block_rms", lambda: optim._ClipByBlockRMS(threshold))


def clip_by_global_norm(max_norm: float):
    """optax.clip_by_global_norm."""
    return _bare("clip_by_global_norm", lambda: _ClipByGlobalNorm(max_norm))


def ema(decay: float, debias: bool = True, accumulator_dtype=None):
    """optax.ema."""
    return _bare("ema", lambda: optim._EMA(decay, accumulator_dtype, debias))


def identity():
    """optax.identity."""
    return _bare("identity", _Identity)


def keep_params_nonnegative():
    """optax.keep_params_nonnegative."""
    return _bare("keep_params_nonnegative", _KeepParamsNonnegative)


def normalize_by_update_norm(scale_factor: float = 1.0, eps: float = 1e-6):
    """optax.normalize_by_update_norm."""
    return _bare("normalize_by_update_norm", lambda: _NormalizeByUpdateNorm(scale_factor, eps))


def set_to_zero():
    """optax.set_to_zero."""
    return _bare("set_to_zero", _SetToZero)


def trace(decay: float, nesterov: bool = False, accumulator_dtype=None):
    """optax.trace."""
    return _bare("trace", lambda: optim._Trace(decay, nesterov, accumulator_dtype))


def zero_nans():
    """optax.zero_nans."""
    return _bare("zero_nans", _ZeroNans)


def apply_every(k: int = 1):
    """optax.apply_every."""
    return _bare("apply_every", lambda: _ApplyEvery(k))


def snapshot(measure_name: str, measure):
    """optax.snapshot: the update unchanged."""
    return _bare("snapshot", _Snapshot)


def stateless(f):
    """optax.stateless: f(updates tree, params tree)."""
    return _bare("stateless", lambda: _Stateless(f, tree_map=False))


def stateless_with_tree_map(f):
    """optax.stateless_with_tree_map: f(update, param) on each leaf."""
    return _bare("stateless_with_tree_map", lambda: _Stateless(f, tree_map=True))


skip_not_finite = optim.skip_not_finite
skip_large_updates = optim.skip_large_updates


# ---- combinators ----


class _Masked(_Combinator):
    """optax.masked: `inner` on the parameters `mask` keeps (its state for
    them alone, under "masked/"); the others take the incoming update as it
    is."""

    def __init__(self, params, inner: Callable, mask, schedule=None):
        super().__init__(params, {}, schedule)
        self.keep = self._mask_list(mask, self._params)
        if not any(self.keep):
            raise ValueError("masked: the mask keeps no parameter")
        self.inner = self._child(inner, self._pairs(self.keep), "masked/")

    def _kids(self) -> list:
        return [self.inner]

    def _layout(self) -> dict:
        return {"inner_state": _Scope(self.inner)}

    def _update(self, group, params, updates):
        idx = [i for i, k in enumerate(self.keep) if k]
        return _merge(updates, {"": (idx, self.inner.update([updates[i] for i in idx]))})


def _merge(updates: List[torch.Tensor], parts: dict) -> List[torch.Tensor]:
    """The updates with each part's (indices, new updates) in place; the
    entries no part holds copied as they are."""
    out = [None] * len(updates)
    for idx, new in parts.values():
        for i, u in zip(idx, new):
            out[i] = u
    rest = [i for i, u in enumerate(out) if u is None]
    if rest:
        for i, u in zip(rest, optim._copy([updates[i] for i in rest])):
            out[i] = u
    return out


def masked(inner, mask, *, mask_compatible_extra_args: bool = False):
    """optax.masked -> `params -> _Masked`."""
    return functools.partial(_Masked, inner=inner, mask=mask)


class _Partition(_Combinator):
    """optax.partition / multi_transform: each label's rule on the
    parameters `param_labels` gives it (its state under "<label>/"). A
    label no parameter has keeps no state here (optax keeps one over no
    leaves, which nothing reads)."""

    def __init__(self, params, transforms: dict, param_labels, schedule=None):
        super().__init__(params, {}, schedule)
        self.labels = [str(v) for v in _tree_values(param_labels, self.names, self._params,
                                                    "param_labels")]
        unknown = set(self.labels) - {str(k) for k in transforms}
        if unknown:
            raise ValueError("Some parameters have no corresponding transformation.\n"
                             f"Parameter labels: {sorted(set(self.labels))} \n"
                             f"Transforms keys: {sorted(str(k) for k in transforms)} \n")
        self.parts = {}
        for label, factory in transforms.items():
            keep = [lab == str(label) for lab in self.labels]
            if any(keep):
                self.parts[str(label)] = self._child(factory, self._pairs(keep), f"{label}/")
        self.order = [str(k) for k in transforms]

    def _kids(self) -> list:
        return list(self.parts.values())

    def _layout(self) -> dict:
        return {"inner_states": {label: {"inner_state": _Scope(self.parts[label])}
                                 if label in self.parts else _Unused() for label in self.order}}

    def _update(self, group, params, updates):
        parts = {}
        for label, kid in self.parts.items():
            idx = [i for i, lab in enumerate(self.labels) if lab == label]
            parts[label] = (idx, kid.update([updates[i] for i in idx]))
        return _merge(updates, parts)


def partition(transforms, param_labels, *, mask_compatible_extra_args: bool = False):
    """optax.partition -> `params -> _Partition`."""
    return functools.partial(_Partition, transforms=dict(transforms), param_labels=param_labels)


def multi_transform(transforms, param_labels, *, mask_compatible_extra_args: bool = False):
    """optax.multi_transform (optax.partition's other name)."""
    return partition(transforms, param_labels)


def freeze(mask):
    """optax.freeze: masked(set_to_zero(), mask)."""
    return masked(set_to_zero(), mask)


def selective_transform(optimizer, *, freeze_mask):
    """optax.selective_transform: partition into "train" (`optimizer`) and
    "freeze" (set_to_zero) by `freeze_mask`."""
    return functools.partial(_Partition, transforms={"train": optimizer, "freeze": set_to_zero()},
                             param_labels=_FreezeLabels(freeze_mask))


class _FreezeLabels:
    """selective_transform's labels: "freeze" where `freeze_mask` holds."""

    def __init__(self, freeze_mask):
        self.freeze_mask = freeze_mask

    def __call__(self, tree):
        def label(node):
            if isinstance(node, dict):
                return {k: label(v) for k, v in node.items()}
            return "freeze" if node else "train"

        if isinstance(self.freeze_mask, bool):
            return "freeze" if self.freeze_mask else "train"
        return label(self.freeze_mask)


class _Flatten(_Combinator):
    """optax.flatten: `inner` on one vector of every entry, the flax
    leaves in JAX's order (sorted by name, a scanned leaf's slices in
    turn); its state is kept on the first parameter under "flat/"."""

    def __init__(self, params, inner: Callable, schedule=None):
        super().__init__(params, {}, schedule)
        if self.names is None:
            self.order = list(range(len(self._params)))
        else:
            self.order = sorted(range(len(self._params)),
                                key=lambda i: (tuple(self.names[i].split(".")), i))
        first = self._params[0]
        total = sum(p.numel() for p in self._params)
        self.flat = torch.zeros(total, dtype=first.dtype, device=first.device)
        self._alias[id(self.flat)] = first
        self.inner = self._child(inner, [("flat", self.flat)], "flat/")

    def _kids(self) -> list:
        return [self.inner]

    def _layout(self) -> dict:
        return _Scope(self.inner)

    def _update(self, group, params, updates):
        with torch.no_grad():
            self.flat.copy_(torch.cat([params[i].reshape(-1) for i in self.order]))
        flat = torch.cat([updates[i].reshape(-1) for i in self.order])
        (new,) = self.inner.update([flat])
        out = [None] * len(updates)
        for i, piece in zip(self.order, new.split([updates[i].numel() for i in self.order])):
            out[i] = piece.view(updates[i].shape)
        return out


def flatten(inner):
    """optax.flatten -> `params -> _Flatten`."""
    return functools.partial(_Flatten, inner=inner)


class _Conditionally(_Combinator):
    """optax.conditionally_transform (`mask` False: a rejected step passes
    the update through) and conditionally_mask (True: a rejected step gives
    zeros); `should_transform_fn(step)` decides on the host for a host
    count, on the device (`_guarded`) for a device one."""

    def __init__(self, params, inner: Callable, should_transform_fn, zero: bool, schedule=None):
        super().__init__(params, {"step": 0}, schedule)
        self.fn, self.zero = should_transform_fn, zero
        self.inner = self._child(inner, self._pairs(), "inner/")

    def _kids(self) -> list:
        return [self.inner]

    def _layout(self) -> dict:
        if self.zero:
            return {"step": _Group("step"), "inner_state": _Scope(self.inner)}
        return {"inner_state": _Scope(self.inner), "step": _Group("step")}

    def _update(self, group, params, updates):
        cond = self.fn(group["step"])
        cond = cond if torch.is_tensor(cond) else bool(cond)
        out = optim._guarded(self.inner, cond, lambda: self.inner.update(updates))
        other = ([torch.zeros_like(u) for u in updates] if self.zero else optim._copy(updates))
        group["step"] = group["step"] + 1
        if out is None:
            return other
        return _select(cond, out, other)


def conditionally_transform(inner, should_transform_fn, forward_extra_args: bool = False):
    """optax.conditionally_transform."""
    return functools.partial(_Conditionally, inner=inner, should_transform_fn=should_transform_fn,
                             zero=False)


def conditionally_mask(inner, should_transform_fn, forward_extra_args: bool = False):
    """optax.conditionally_mask."""
    return functools.partial(_Conditionally, inner=inner, should_transform_fn=should_transform_fn,
                             zero=True)


def with_extra_args_support(tx):
    """optax.with_extra_args_support: the rule itself (the port's rules
    take no extra arguments)."""
    return tx


class _InjectHyperparams(_Combinator):
    """optax.inject_hyperparams: the rule `inner_factory(*args, **kwargs)`
    under "inner/", each float argument rounded to f32 as optax holds it.
    optax rebuilds the rule every step with each schedule among the
    arguments read at its own count, which the rule's own count equals: the
    port builds it once with the schedules. optax's state keeps the
    hyperparameters' values (not carried: they are the arguments) and the
    rule's state as a rule built from numbers keeps it (a schedule
    argument's count is the injector's)."""

    def __init__(self, params, inner_factory: Callable, args: tuple, kwargs: dict,
                 static_args=(), schedule=None):
        super().__init__(params, {"count": 0}, schedule)
        static = {static_args} if isinstance(static_args, str) else set(static_args)
        bound = inspect.signature(inner_factory).bind(*args, **kwargs)
        bound.apply_defaults()
        # optax holds each float hyperparameter as an f32 array
        values = {k: float(np.float32(v)) if isinstance(v, float) and k not in static else v
                  for k, v in bound.arguments.items()}
        self.inner = self._child(inner_factory(**values), self._pairs(), "inner/")
        twin = inner_factory(**{k: 0.0 if callable(v) and k not in static else v
                                for k, v in values.items()})(self._pairs())
        # a rule's tree as optax builds it from numbers; a wrapper's is its own
        self.twin = twin if isinstance(twin, optim._OptaxRule) else self.inner

    def _kids(self) -> list:
        return [self.inner]

    def _advance(self, group) -> None:
        group["count"] = group["count"] + 1
        group["schedule_count"] += 1

    def _layout(self) -> dict:
        scope = _Scope(self.inner)
        scope.layout = self.twin._layout()
        return {"count": _Count(), "hyperparams": _Unused(), "hyperparams_states": _Unused(),
                "inner_state": scope}

    def _update(self, group, params, updates):
        return self.inner.update(updates)


def inject_hyperparams(inner_factory, static_args=(), hyperparam_dtype=None):
    """optax.inject_hyperparams(inner_factory) -> a function of the
    factory's arguments that returns `params -> _InjectHyperparams`, as
    optax's returns a function that returns the rule."""
    def wrapped(*args, **kwargs):
        return functools.partial(_InjectHyperparams, inner_factory=inner_factory, args=args,
                                 kwargs=kwargs, static_args=static_args)

    return wrapped


def inject_stateful_hyperparams(inner_factory, static_args=(), hyperparam_dtype=None):
    """optax.inject_stateful_hyperparams (the same for the port's
    schedules, which keep no state of their own)."""
    return inject_hyperparams(inner_factory, static_args, hyperparam_dtype)
