"""optax.contrib's rules and wrappers (optax 0.2.6) on the transform layer
of `train/optim.py`.

The rules: `acprop`, `ademamix`, `simplified_ademamix`, `adopt`, `cocob`,
`dadapt_adamw`, `dog`, `dowg`, `muon`, `prodigy`, `schedule_free_adamw`,
`schedule_free_sgd`, `normalize`, and their `scale_by_*` steps as bare
transforms. The wrappers: `mechanize`, `schedule_free`, `sam`,
`split_real_and_imaginary`. Each factory returns what optax's returns, a
rule not yet bound to parameters (`params -> torch optimizer`), and each
rule declares optax's state tree, so that it resumes JAX's state.

Tree-wide scalars (prodigy's and D-Adaptation's learning-rate estimates,
DoG's and DoWG's distances, Mechanic's betas, schedule-free's weights)
stay f32 tensors on the parameters' device, kept in the rule's group:
a step reads none of them on the host. Their sums over the tree (dot
products, L1 and L2 norms) run over the tensors in the parameters' order,
each tensor's own sum as torch orders it, so they differ from XLA's in the
last bits; the tests hold the parameters to optax's within 1e-6 after 20
steps all the same.

`muon` labels a flax leaf "muon" when it has two axes, else "adam", as
optax does on flax's tree: a scanned E3Conv's stacked 3-d leaves go to
Adam, its stacked biases (2-d) to Newton-Schulz. Newton-Schulz runs on the flax orientation ([in, out]: the kernels
are not transposed), with `torch.matmul` as JAX's products run outside any
Pallas kernel. `schedule_free_*` trains the interpolated point y and keeps
z in its state; JAX's trainer never calls `schedule_free_eval_params`, so
validation and the EMA read the trained parameters in both.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from jamun_tpu_torch.train import optim
from jamun_tpu_torch.train.optim import (
    _bias,
    _Chain,
    _chain,
    _copy,
    _Count,
    _dtype,
    _f32,
    _Group,
    _Initial,
    _moment,
    _Param,
    _Scope,
    _Step,
    _Unused,
    _value,
    _Wrapper,
)
from jamun_tpu_torch.train.optim import _axpy, _l1, _sq_norm, _vdot
from jamun_tpu_torch.train.optim_transforms import _bare, _Identity, _Normalize, _ScaleByRms, partition

RULES = (
    "acprop", "ademamix", "simplified_ademamix", "adopt", "cocob", "dadapt_adamw", "dog", "dowg",
    "muon", "prodigy", "schedule_free_adamw", "schedule_free_sgd", "normalize",
)
WRAPPERS = ("mechanize", "schedule_free", "sam", "split_real_and_imaginary")
TRANSFORMS = (
    "scale_by_acprop", "scale_by_ademamix", "scale_by_adopt", "scale_by_cocob",
    "scale_by_simplified_ademamix",
)

__all__ = [*RULES, *WRAPPERS, *TRANSFORMS]


def _rule(alias: str, learning_rate, make_steps: Callable):
    return functools.partial(_Chain, make_steps=make_steps, lr=learning_rate, alias=alias)


def _f32_scalar(x) -> float:
    """x rounded to f32 (a Python float), as JAX holds a weak scalar."""
    return float(_f32(x))


def _decay_or_identity(weight_decay, mask) -> _Step:
    if weight_decay is None:
        return _Identity()
    return optim._AddDecayedWeights(weight_decay, mask)


# ---- optax.contrib's steps ----


class _ScaleByAcprop(_Step):
    """optax.contrib.scale_by_acprop: the gradient over the root of the
    bias-corrected variance of its prediction error (the state before this
    step's; 1 on the first step)."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}

    def __call__(self, rule, group, params, updates):
        count = group["count"]
        mu = rule._state(params, "mu", torch.zeros_like)
        nu = rule._state(params, "nu", torch.zeros_like)
        err = torch._foreach_sub(updates, mu)
        initial = count == 0
        if torch.is_tensor(count):
            t = torch.where(initial, count + 1, count)
            hat = [torch.where(initial, 1.0, v / _bias(self.b2, t)) for v in nu]
        elif initial:
            hat = [torch.ones_like(v) for v in nu]
        else:
            hat = torch._foreach_div(nu, _bias(self.b2, count))
        torch._foreach_sqrt_(hat)
        torch._foreach_add_(hat, self.eps)
        out = torch._foreach_div(updates, hat)
        optim._ema_(mu, updates, self.b1)
        optim._ema_sq_(nu, err, self.b2)
        torch._foreach_add_(nu, self.eps_root)
        return out


class _ScaleByAdemamix(_Step):
    """optax.contrib.scale_by_ademamix: Adam's moments and a slow one (b3),
    (m1_hat + alpha m2) / (sqrt(nu_hat + eps_root) + eps); b3 and alpha
    may be schedules of `count_m2`."""

    def __init__(self, b1=0.9, b2=0.999, b3=0.9999, alpha=6.0, eps=1e-8, eps_root=0.0,
                 mu_dtype=None):
        self.b1, self.b2, self.b3, self.alpha = b1, b2, b3, alpha
        self.eps, self.eps_root, self.mu_dtype = eps, eps_root, _dtype(mu_dtype)

    def layout(self, rule) -> dict:
        return {"count": _Count(), "count_m2": _Count(), "m1": _Param("m1"), "m2": _Param("m2"),
                "nu": _Param("nu")}

    def __call__(self, rule, group, params, updates):
        count = group["count"]
        # a schedule's value is an f32 array in optax: 1 - b3 rounds in f32
        b3 = _f32(self.b3(count)) if callable(self.b3) and not torch.is_tensor(count) else (
            self.b3(count) if callable(self.b3) else self.b3)
        alpha = _value(self.alpha(count)) if callable(self.alpha) else self.alpha
        zeros = lambda p: torch.zeros_like(p, dtype=self.mu_dtype)  # noqa: E731
        m1, m2, nu = (rule._state(params, k, zeros) for k in ("m1", "m2", "nu"))
        new_m1 = _moment(updates, m1, self.b1)
        if isinstance(b3, np.floating):
            b3, c3 = float(b3), float(_f32(1) - b3)
        else:
            c3 = 1 - b3
        new_m2 = [c3 * g + b3 * m for g, m in zip(updates, m2)]
        new_nu = [(1 - self.b2) * (g * g) + self.b2 * v for g, v in zip(updates, nu)]
        t = count + 1
        num = torch._foreach_div(new_m1, _bias(self.b1, t))
        torch._foreach_add_(num, torch._foreach_mul(new_m2, alpha))
        den = torch._foreach_div(new_nu, _bias(self.b2, t))
        torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        for p, a, b, c in zip(params, new_m1, new_m2, new_nu):
            rule.state[p]["m1"], rule.state[p]["m2"], rule.state[p]["nu"] = a, b, c
        return torch._foreach_div(num, den)


class _ScaleBySimplifiedAdemamix(_Step):
    """optax.contrib.scale_by_simplified_ademamix: m = g + b1 m, n the lerp
    of g^2 and n by b2, (m + alpha g) / (sqrt(n_hat + eps_root) + eps)."""

    def __init__(self, b1=0.99, b2=0.95, alpha=0.0, eps=1e-8, eps_root=0.0):
        self.b1, self.b2, self.alpha, self.eps, self.eps_root = b1, b2, alpha, eps, eps_root

    def layout(self, rule) -> dict:
        return {"t": _Count(), "m": _Param("m"), "n": _Param("n")}

    def __call__(self, rule, group, params, updates):
        m = rule._state(params, "m", torch.zeros_like)
        n = rule._state(params, "n", torch.zeros_like)
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, updates)
        sq = torch._foreach_mul(updates, updates)
        diff = torch._foreach_sub(n, sq)
        torch._foreach_mul_(diff, self.b2)
        new_n = torch._foreach_add(sq, diff)
        for p, v in zip(params, new_n):
            rule.state[p]["n"] = v
        num = torch._foreach_add(m, torch._foreach_mul(updates, self.alpha))
        den = torch._foreach_div(new_n, _bias(self.b2, group["count"] + 1))
        torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(num, den)


def _quarter_root(count):
    """ADOPT's default clip value, count ** 0.25 in f32."""
    if torch.is_tensor(count):
        return count.to(torch.float32) ** 0.25
    return float(_f32(count) ** _f32(0.25))


class _ScaleByAdopt(_Step):
    """optax.contrib.scale_by_adopt: the gradient over the root of the last
    step's nu (clipped to clip_value_fn(count)) into the moment; on the
    first step b1 = 1 and b2 = 0, so the update is zero. b1 and b2 are
    chosen in f32, as optax's `jnp.where` holds them."""

    def __init__(self, b1=0.9, b2=0.9999, eps=1e-6, mu_dtype=None, nesterov=False,
                 use_clipping=True, clip_value_fn=_quarter_root):
        self.b1, self.b2, self.eps, self.mu_dtype = b1, b2, eps, _dtype(mu_dtype)
        self.nesterov, self.use_clipping, self.clip_value_fn = nesterov, use_clipping, clip_value_fn

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}

    def __call__(self, rule, group, params, updates):
        count = group["count"]
        if torch.is_tensor(count):
            on = count > 0
            b2 = torch.where(on, _f32_scalar(self.b2), 0.0)
            b1 = torch.where(on, _f32_scalar(self.b1), 1.0)
            c2, c1 = 1 - b2, 1 - b1
        else:
            b2 = _f32(self.b2) if count > 0 else _f32(0)
            b1 = _f32(self.b1) if count > 0 else _f32(1)
            c2, c1 = float(_f32(1) - b2), float(_f32(1) - b1)
            b2, b1 = float(b2), float(b1)
        mu = rule._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
        nu = rule._state(params, "nu", torch.zeros_like)
        scaled = [g / torch.clamp_min(torch.sqrt(v), self.eps) for g, v in zip(updates, nu)]
        if self.use_clipping:
            cv = self.clip_value_fn(count)
            scaled = [torch.clamp(x, -cv, cv) if not torch.is_tensor(cv)
                      else torch.minimum(torch.maximum(x, -cv), cv) for x in scaled]
        new_nu = [c2 * (g * g) + b2 * v for g, v in zip(updates, nu)]
        new_mu = [c1 * x + b1 * m for x, m in zip(scaled, mu)]
        out = [c1 * x + b1 * m for x, m in zip(scaled, new_mu)] if self.nesterov else _copy(new_mu)
        for p, a, b in zip(params, new_mu, new_nu):
            rule.state[p]["mu"], rule.state[p]["nu"] = a.to(self.mu_dtype or a.dtype), b
        return out


class _ScaleByCocob(_Step):
    """optax.contrib.scale_by_cocob: coin betting; the update moves the
    parameters to p0 + C / (L max(G + L, alpha L)) (L + R)."""

    def __init__(self, alpha=100, eps=1e-8):
        self.alpha, self.eps = alpha, eps

    def layout(self, rule) -> dict:
        return {"init_particles": _Param("init_particles"),
                "cumulative_gradients": _Param("cumulative_gradients"), "scale": _Param("scale"),
                "subgradients": _Param("subgradients"), "reward": _Param("reward")}

    def __call__(self, rule, group, params, updates):
        p0 = rule._state(params, "init_particles", lambda p: p.detach().clone())
        C = rule._state(params, "cumulative_gradients", torch.zeros_like)
        L = rule._state(params, "scale", lambda p: torch.full_like(p, self.eps))
        G = rule._state(params, "subgradients", torch.zeros_like)
        R = rule._state(params, "reward", torch.zeros_like)
        size = torch._foreach_abs(updates)
        L = torch._foreach_maximum(L, size)
        G = torch._foreach_add(G, size)
        moved = torch._foreach_sub(params, p0)
        torch._foreach_mul_(moved, updates)
        R = torch._foreach_sub(R, moved)
        torch._foreach_clamp_min_(R, 0.0)
        C = torch._foreach_sub(C, updates)
        for p, lo, gs, r, c in zip(params, L, G, R, C):
            st = rule.state[p]
            st["scale"], st["subgradients"], st["reward"], st["cumulative_gradients"] = lo, gs, r, c
        # -p + (p0 + C / (L max(G + L, alpha L)) (L + R))
        den = torch._foreach_add(G, L)
        torch._foreach_maximum_(den, torch._foreach_mul(L, self.alpha))
        den = torch._foreach_mul(L, den)
        out = torch._foreach_div(C, den)
        torch._foreach_mul_(out, torch._foreach_add(L, R))
        out = torch._foreach_add(p0, out)
        torch._foreach_sub_(out, params)
        return out


def _bias_sqrt_ratio(b1: float, b2: float, t):
    """(1 - b2^t)^0.5 / (1 - b1^t) in f32 (a tensor for a device count)."""
    c2, c1 = _bias(b2, t), _bias(b1, t)
    if torch.is_tensor(c2):
        return c2**0.5 / c1
    return float(_f32(c2) ** _f32(0.5) / _f32(c1))


class _DAdaptAdamW(_Step):
    """optax.contrib.dadapt_adamw: Adam whose step size is D-Adaptation's
    estimate of the distance to the solution (`estim_lr`, a tree-wide
    scalar on the device)."""

    def __init__(self, learning_rate=1.0, betas=(0.9, 0.999), eps=1e-8, estim_lr0=1e-6,
                 weight_decay=0.0):
        self.lr, (self.b1, self.b2) = learning_rate, betas
        self.eps, self.estim_lr0, self.wd = eps, estim_lr0, weight_decay

    def layout(self, rule) -> dict:
        return {"exp_avg": _Param("exp_avg"), "exp_avg_sq": _Param("exp_avg_sq"),
                "grad_sum": _Param("grad_sum"),
                "estim_lr": _Group("estim_lr", device=True),
                "numerator_weighted": _Group("numerator_weighted", device=True),
                "count": _Count()}

    def __call__(self, rule, group, params, updates):
        dev, count = params[0].device, group["count"]
        b1, b2 = self.b1, self.b2
        sb2 = b2**0.5
        estim = rule._scalar("estim_lr", dev, self.estim_lr0)
        nw = rule._scalar("numerator_weighted", dev, 0.0)
        sched = _value(self.lr(count)) if callable(self.lr) else self.lr
        dlr = estim * sched * _bias_sqrt_ratio(b1, b2, count + 1)
        ea = rule._state(params, "exp_avg", torch.zeros_like)
        eas = rule._state(params, "exp_avg_sq", torch.zeros_like)
        gs = rule._state(params, "grad_sum", torch.zeros_like)
        den = torch._foreach_sqrt(eas)
        torch._foreach_add_(den, self.eps)
        acc = _vdot(updates, torch._foreach_div(gs, den))
        ea = _axpy(ea, b1, updates, (1 - b1) * dlr)
        sq = torch._foreach_mul(updates, 1 - b2)
        torch._foreach_mul_(sq, updates)
        eas = _axpy(eas, b2, sq, 1.0)
        gs = _axpy(gs, sb2, updates, (1 - sb2) * dlr)
        for p, a, b, c in zip(params, ea, eas, gs):
            rule.state[p]["exp_avg"], rule.state[p]["exp_avg_sq"], rule.state[p]["grad_sum"] = a, b, c
        nw = sb2 * nw + (1 - sb2) * dlr * acc
        group["numerator_weighted"] = nw
        group["estim_lr"] = torch.maximum(estim, nw / ((1 - sb2) * _l1(gs)))
        den = torch._foreach_sqrt(eas)
        torch._foreach_add_(den, self.eps)
        out = torch._foreach_mul(params, -self.wd * dlr)
        torch._foreach_sub_(out, torch._foreach_div(ea, den))
        return out


class _Prodigy(_Step):
    """optax.contrib.prodigy: Adam on estim_lr g, the step size the
    estimate of the distance to the solution from the first parameters
    (`estim_lr`, a tree-wide scalar on the device)."""

    def __init__(self, learning_rate=1.0, betas=(0.9, 0.999), beta3=None, eps=1e-8,
                 estim_lr0=1e-6, estim_lr_coef=1.0, weight_decay=0.0, safeguard_warmup=False):
        self.lr, (self.b1, self.b2) = learning_rate, betas
        self.b3 = self.b2**0.5 if beta3 is None else beta3
        self.eps, self.estim_lr0, self.coef = eps, estim_lr0, estim_lr_coef
        self.wd, self.safeguard = weight_decay, safeguard_warmup

    def layout(self, rule) -> dict:
        return {"exp_avg": _Param("exp_avg"), "exp_avg_sq": _Param("exp_avg_sq"),
                "grad_sum": _Param("grad_sum"), "params0": _Param("params0"),
                "estim_lr": _Group("estim_lr", device=True),
                "numerator_weighted": _Group("numerator_weighted", device=True),
                "count": _Count()}

    def __call__(self, rule, group, params, updates):
        dev, count = params[0].device, group["count"]
        b1, b2, b3, lr0 = self.b1, self.b2, self.b3, self.estim_lr0
        estim = rule._scalar("estim_lr", dev, lr0)
        nw = rule._scalar("numerator_weighted", dev, 0.0)
        sched = _value(self.lr(count)) if callable(self.lr) else self.lr
        dlr = estim * sched * _bias_sqrt_ratio(b1, b2, count + 1)
        ea = rule._state(params, "exp_avg", torch.zeros_like)
        eas = rule._state(params, "exp_avg_sq", torch.zeros_like)
        gs = rule._state(params, "grad_sum", torch.zeros_like)
        p0 = rule._state(params, "params0", lambda p: p.detach().clone())
        acc = _vdot(updates, torch._foreach_sub(p0, params))
        dg = torch._foreach_mul(updates, estim)
        ea = _axpy(ea, b1, dg, 1 - b1)
        sq = torch._foreach_mul(dg, 1 - b2)
        torch._foreach_mul_(sq, dg)
        eas = _axpy(eas, b2, sq, 1.0)
        step = torch._foreach_mul(dg, estim if self.safeguard else dlr)
        torch._foreach_div_(step, lr0)
        gs = _axpy(gs, b3, step, 1.0)
        for p, a, b, c in zip(params, ea, eas, gs):
            rule.state[p]["exp_avg"], rule.state[p]["exp_avg_sq"], rule.state[p]["grad_sum"] = a, b, c
        nw = b3 * nw + estim / lr0 * dlr * acc
        estim = torch.maximum(estim, self.coef * nw / _l1(gs))
        group["numerator_weighted"], group["estim_lr"] = nw, estim
        eps = estim * self.eps  # a device scalar: added tensor by tensor (the
        den = [d + eps for d in torch._foreach_sqrt(eas)]  # foreach add of one reads it)
        out = torch._foreach_mul(params, -self.wd * dlr)
        torch._foreach_sub_(out, torch._foreach_div(torch._foreach_mul(ea, dlr), den))
        return out


class _ScaleByDog(_Step):
    """optax.contrib's scale_by_dog: the update times the largest distance
    from the first parameters over the root of the summed squared gradient
    norms (tree-wide scalars on the device); on the first step the given
    learning rate with init_step "learning_rate"."""

    def __init__(self, init_step=("heuristic", 1e-6), eps=1e-8):
        kind, value = init_step
        if kind not in ("distance", "learning_rate", "heuristic"):
            raise ValueError(f"Invalid init_step specification for scale_by_dog: "
                             f"init_step_type={kind!r}")
        self.kind, self.value, self.eps = kind, value, eps

    def layout(self, rule) -> dict:
        return {"is_init_step": _Initial(), "init_params": _Param("init_params"),
                "max_dist": _Group("max_dist", device=True),
                "sum_sq_norm_grads": _Group("sum_sq_norm_grads", device=True)}

    def __call__(self, rule, group, params, updates):
        dev = params[0].device
        if "max_dist" not in group:
            group["max_dist"] = (self.value * (1 + _sq_norm(params).sqrt())
                                 if self.kind == "heuristic"
                                 else self.value if self.kind == "distance" else 0.0)
        p0 = rule._state(params, "init_params", lambda p: p.detach().clone())
        max_dist = torch.maximum(rule._scalar("max_dist", dev),
                                 _sq_norm(torch._foreach_sub(p0, params)).sqrt())
        sq = rule._scalar("sum_sq_norm_grads", dev, 0.0) + _sq_norm(updates)
        lr = max_dist / torch.sqrt(sq + self.eps)
        if self.kind == "learning_rate":
            lr = optim._select(group["count"] == 0, self.value, lr)
            lr = lr if torch.is_tensor(lr) else torch.full((), lr, device=dev)
        group["max_dist"], group["sum_sq_norm_grads"] = max_dist, sq
        return torch._foreach_mul(updates, lr)


class _ScaleByDowg(_Step):
    """optax.contrib's scale_by_dowg: DoG weighted by the squared distance
    estimate (tree-wide scalars on the device)."""

    def __init__(self, init_estim_sq_dist=None, eps=1e-4):
        self.init = eps if init_estim_sq_dist is None else init_estim_sq_dist
        self.eps = eps

    def layout(self, rule) -> dict:
        return {"init_params": _Param("init_params"),
                "weighted_sq_norm_grads": _Group("weighted_sq_norm_grads", device=True),
                "estim_sq_dist": _Group("estim_sq_dist", device=True)}

    def __call__(self, rule, group, params, updates):
        dev = params[0].device
        p0 = rule._state(params, "init_params", lambda p: p.detach().clone())
        estim = torch.maximum(rule._scalar("estim_sq_dist", dev, self.init),
                              _sq_norm(torch._foreach_sub(p0, params)))
        weighted = (estim * _sq_norm(updates)
                    + rule._scalar("weighted_sq_norm_grads", dev, 0.0))
        group["estim_sq_dist"], group["weighted_sq_norm_grads"] = estim, weighted
        return torch._foreach_mul(updates, estim / (torch.sqrt(weighted) + self.eps))


def _flax_ndim(name: str, p: torch.Tensor) -> int:
    """The axes of a parameter's flax leaf: a scanned layer's slice has the
    stacked leaf's one more."""
    from jamun_tpu_torch.params import SCANNED

    return p.ndim + (name.split(".")[0] == SCANNED)


def _newton_schulz(x: torch.Tensor, coeffs, steps: int, eps: float) -> torch.Tensor:
    """optax's orthogonalize_via_newton_schulz of a stack of [in, out]
    matrices (reduction axis 0, output axis 1), each as optax's vmap takes
    it: transposed to the wide side, normalised, `steps` iterations of (c0,
    c1, c2) or one per row of coefficients."""
    wide = x.shape[-2] > x.shape[-1]
    if wide:
        x = x.mT
    x = x / (torch.linalg.norm(x, dim=(-2, -1), keepdim=True) + eps)
    rows = coeffs if isinstance(coeffs[0], (tuple, list)) else [coeffs] * steps
    for c0, c1, c2 in rows:
        a = x @ x.mT
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.mT if wide else x


class _ScaleByMuon(_Step):
    """optax.contrib.scale_by_muon: the Nesterov momentum of each [in, out]
    leaf orthogonalised by Newton-Schulz and scaled by sqrt(max(1,
    out/in)). optax refuses a leaf of fewer than two axes; so does the
    port."""

    def __init__(self, ns_coeffs=(3.4445, -4.775, 2.0315), ns_steps=5, beta=0.95, eps=1e-8,
                 mu_dtype=None, nesterov=True, adaptive=False):
        self.coeffs = tuple(tuple(float(c) for c in row) for row in ns_coeffs) if isinstance(
            ns_coeffs[0], (tuple, list)) else tuple(float(c) for c in ns_coeffs)
        self.steps, self.beta, self.eps = ns_steps, beta, eps
        self.mu_dtype, self.nesterov, self.adaptive = _dtype(mu_dtype), nesterov, adaptive

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "ns_coeffs": _Unused()}

    def __call__(self, rule, group, params, updates):
        beta, t = self.beta, group["count"] + 1
        mu = rule._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
        new_mu = _moment(updates, mu, beta)
        if self.nesterov:
            hat = [beta * (m / _bias(beta, t + 1)) + (1 - beta) * (g / _bias(beta, t))
                   for m, g in zip(new_mu, updates)]
        else:
            hat = torch._foreach_div(new_mu, _bias(beta, t))
        # the flax leaves (a scanned layer's slices stacked), those of one
        # shape orthogonalised together as one batch
        leaves = {}
        for name, idx in zip(rule.leaf_names(), rule._leaves()):
            scanned = _flax_ndim(name, params[idx[0]]) > params[idx[0]].ndim
            h = torch.stack([hat[i] for i in idx]) if scanned else hat[idx[0]]
            if h.ndim != 2:
                raise ValueError(f"Muon's Newton-Schulz takes [in, out] leaves; leaf {name!r} has "
                                 f"{h.ndim} axes (optax refuses it too)")
            leaves.setdefault(tuple(h.shape), []).append((idx, scanned, h))
        out = [None] * len(params)
        for (rows, cols), group_leaves in leaves.items():
            h = torch.stack([leaf for _, _, leaf in group_leaves])
            o = _newton_schulz(h, self.coeffs, self.steps, self.eps)
            if self.adaptive:
                o = torch.sum(h * o, dim=(-2, -1), keepdim=True) * o
            o = math.sqrt(max(1.0, cols / rows)) * o
            for (idx, scanned, _), leaf in zip(group_leaves, o.unbind()):
                for k, i in enumerate(idx):
                    out[i] = leaf[k] if scanned else leaf
        for p, m in zip(params, new_mu):
            rule.state[p]["mu"] = m.to(self.mu_dtype or m.dtype)
        return out


# ---- the rules ----


def acprop(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
           eps_root: float = 1e-16, weight_decay: float = 0.0, mask=None):
    """optax.contrib.acprop."""
    return _rule("acprop", learning_rate, lambda: [
        _ScaleByAcprop(b1, b2, eps, eps_root), optim._AddDecayedWeights(weight_decay, mask),
        optim._ScaleByLR(learning_rate)])


def ademamix(learning_rate, b1: float = 0.9, b2: float = 0.999, b3=0.9999, alpha=5.0,
             eps: float = 1e-8, eps_root: float = 0.0, mu_dtype=None, weight_decay: float = 0.0,
             mask=None):
    """optax.contrib.ademamix."""
    return _rule("ademamix", learning_rate, lambda: [
        _ScaleByAdemamix(b1, b2, b3, alpha, eps, eps_root, mu_dtype),
        optim._AddDecayedWeights(weight_decay, mask), optim._ScaleByLR(learning_rate)])


def simplified_ademamix(learning_rate, b1: float = 0.99, b2: float = 0.95, alpha=0.0,
                        eps: float = 1e-8, eps_root: float = 0.0, weight_decay: float = 0.0,
                        mask=None):
    """optax.contrib.simplified_ademamix."""
    return _rule("simplified_ademamix", learning_rate, lambda: [
        _ScaleBySimplifiedAdemamix(b1, b2, alpha, eps, eps_root),
        optim._AddDecayedWeights(weight_decay, mask), optim._ScaleByLR(learning_rate)])


def adopt(learning_rate, b1: float = 0.9, b2: float = 0.9999, eps: float = 1e-6, mu_dtype=None,
          *, nesterov: bool = False, use_clipping: bool = True, clip_value_fn=_quarter_root):
    """optax.contrib.adopt."""
    return _rule("adopt", learning_rate, lambda: [
        _ScaleByAdopt(b1, b2, eps, mu_dtype, nesterov, use_clipping, clip_value_fn),
        optim._ScaleByLR(learning_rate)])


def cocob(learning_rate=1.0, alpha: float = 100, eps: float = 1e-8, weight_decay: float = 0,
          mask=None):
    """optax.contrib.cocob."""
    return _rule("cocob", learning_rate, lambda: [
        optim._AddDecayedWeights(weight_decay, mask),
        optim._ScaleByLR(learning_rate, flip_sign=False), _ScaleByCocob(alpha, eps)])


def dadapt_adamw(learning_rate=1.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 estim_lr0: float = 1e-6, weight_decay: float = 0.0):
    """optax.contrib.dadapt_adamw (one transform: its state is not a
    chain's)."""
    return _bare("dadapt_adamw", lambda: _DAdaptAdamW(learning_rate, tuple(betas), eps, estim_lr0,
                                                      weight_decay))


def prodigy(learning_rate=1.0, betas=(0.9, 0.999), beta3: Optional[float] = None,
            eps: float = 1e-8, estim_lr0: float = 1e-6, estim_lr_coef: float = 1.0,
            weight_decay: float = 0.0, safeguard_warmup: bool = False):
    """optax.contrib.prodigy (one transform)."""
    return _bare("prodigy", lambda: _Prodigy(learning_rate, tuple(betas), beta3, eps, estim_lr0,
                                             estim_lr_coef, weight_decay, safeguard_warmup))


def dog(learning_rate=1.0, init_step=("heuristic", 1e-6), eps: float = 1e-8,
        weight_decay: Optional[float] = None, mask=None):
    """optax.contrib.dog."""
    return _rule("dog", learning_rate, lambda: [
        _decay_or_identity(weight_decay, mask), _ScaleByDog(tuple(init_step), eps),
        optim._ScaleByLR(learning_rate)])


def dowg(learning_rate=1.0, init_estim_sq_dist: Optional[float] = None, eps: float = 1e-4,
         weight_decay: Optional[float] = None, mask=None):
    """optax.contrib.dowg."""
    return _rule("dowg", learning_rate, lambda: [
        _decay_or_identity(weight_decay, mask), _ScaleByDowg(init_estim_sq_dist, eps),
        optim._ScaleByLR(learning_rate)])


def normalize():
    """optax.contrib.normalize: u / |u|."""
    return _bare("normalize", _Normalize)


def _muon_labels(tree):
    """muon's labels on flax's tree: "muon" for a leaf of two axes."""
    return {k: _muon_labels(v) if isinstance(v, dict) else ("muon" if v.ndim == 2 else "adam")
            for k, v in tree.items()}


def muon(learning_rate, ns_coeffs=(3.4445, -4.775, 2.0315), ns_steps: int = 5, beta: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.0, weight_decay_mask=None, mu_dtype=None, *,
         nesterov: bool = True, adaptive: bool = False, adam_b1: float = 0.9,
         adam_b2: float = 0.999, adam_eps_root: float = 0.0, adam_weight_decay: float = 0.0,
         muon_weight_dimension_numbers=None):
    """optax.contrib.muon (the default dimension numbers: every 2-d leaf is
    [in, out])."""
    if muon_weight_dimension_numbers is not None:
        raise NotImplementedError(f"muon's muon_weight_dimension_numbers is not ported "
                                  f"({optim._OTHER})")
    muon_rule = _rule("muon", learning_rate, lambda: [
        _ScaleByMuon(ns_coeffs, ns_steps, beta, eps, mu_dtype, nesterov, adaptive),
        optim._AddDecayedWeights(weight_decay, weight_decay_mask),
        optim._ScaleByLR(learning_rate)])
    adam_rule = optim.adamw(learning_rate, b1=adam_b1, b2=adam_b2, eps=eps,
                            eps_root=adam_eps_root, weight_decay=adam_weight_decay,
                            mu_dtype=mu_dtype, nesterov=nesterov)
    return partition({"muon": muon_rule, "adam": adam_rule}, _muon_labels)


# ---- bare transforms of optax.contrib ----


def scale_by_acprop(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
                    eps_root: float = 1e-16):
    """optax.contrib.scale_by_acprop."""
    return _bare("scale_by_acprop", lambda: _ScaleByAcprop(b1, b2, eps, eps_root))


def scale_by_ademamix(b1: float = 0.9, b2: float = 0.999, b3=0.9999, alpha=6.0, eps: float = 1e-8,
                      eps_root: float = 0.0, mu_dtype=None):
    """optax.contrib.scale_by_ademamix."""
    return _bare("scale_by_ademamix", lambda: _ScaleByAdemamix(b1, b2, b3, alpha, eps, eps_root,
                                                               mu_dtype))


def scale_by_adopt(b1: float = 0.9, b2: float = 0.9999, eps: float = 1e-6, mu_dtype=None, *,
                   nesterov: bool = False, use_clipping: bool = True,
                   clip_value_fn=_quarter_root):
    """optax.contrib.scale_by_adopt."""
    return _bare("scale_by_adopt", lambda: _ScaleByAdopt(b1, b2, eps, mu_dtype, nesterov,
                                                         use_clipping, clip_value_fn))


def scale_by_cocob(alpha: float = 100, eps: float = 1e-8):
    """optax.contrib.scale_by_cocob."""
    return _bare("scale_by_cocob", lambda: _ScaleByCocob(alpha, eps))


def scale_by_simplified_ademamix(b1: float = 0.99, b2: float = 0.95, alpha=0.0, eps: float = 1e-8,
                                 eps_root: float = 0.0):
    """optax.contrib.scale_by_simplified_ademamix."""
    return _bare("scale_by_simplified_ademamix", lambda: _ScaleBySimplifiedAdemamix(
        b1, b2, alpha, eps, eps_root))


# ---- the wrappers ----


class _ScheduleFree(_Wrapper):
    """optax.contrib.schedule_free: the base rule steps z; the parameters
    are y = b1 x + (1 - b1) z, x the average of the z's weighted by
    max_lr^weight_lr_power (`weight_sum`, `max_lr`: device scalars). The
    learning rate (a schedule: read at `step_count`, from 1) sets the
    weights only."""

    _OWN = ("weight_sum", "step_count", "max_lr", "schedule_count", "z")

    def __init__(self, params, base_optimizer: Callable, learning_rate, b1: float = 0.9,
                 weight_lr_power: float = 2.0, state_dtype=None, schedule=None):
        super().__init__(params, base_optimizer, dict(weight_sum=0.0, step_count=1, max_lr=0.0),
                         schedule)
        self.lr, self.b1, self.power = learning_rate, b1, weight_lr_power
        self.state_dtype = _dtype(state_dtype)

    def _layout(self) -> dict:
        return {"b1": _Unused(), "weight_sum": _Group("weight_sum", device=True),
                "step_count": _Group("step_count"), "max_lr": _Group("max_lr", device=True),
                "base_optimizer_state": _Scope(self.inner), "z": _Param("z")}

    def _update(self, group, params, grads):
        dev, b1 = params[0].device, self.b1
        step = group["step_count"]
        lr = _value(self.lr(step)) if callable(self.lr) else self.lr
        lr = lr if torch.is_tensor(lr) else torch.full((), lr, device=dev)
        max_lr = torch.maximum(self._scalar("max_lr", dev), lr)
        weight = max_lr**self.power
        total = self._scalar("weight_sum", dev) + weight
        ck = torch.where(torch.isnan(weight) | torch.isnan(total), torch.nan,
                         torch.nan_to_num(weight / total, nan=0.0, posinf=math.inf))
        z = self._state(params, "z", lambda p: p.detach().to(self.state_dtype or p.dtype,
                                                             copy=True))
        zn = torch._foreach_add(z, self.inner.update(grads))
        if self.state_dtype is not None:
            zn = [x.to(old.dtype) for x, old in zip(zn, z)]
        # x = (1 - ck) (y - (1 - b1) z) / b1 + ck z', y' = b1 x + (1 - b1) z'
        x = torch._foreach_sub(params, torch._foreach_mul(z, 1.0 - b1))
        torch._foreach_div_(x, b1)
        x = _axpy(x, 1.0 - ck, zn, ck)
        out = _axpy(x, b1, zn, 1.0 - b1)
        torch._foreach_sub_(out, params)
        for p, v in zip(params, zn):
            self.state[p]["z"] = v
        group["max_lr"], group["weight_sum"], group["step_count"] = max_lr, total, step + 1
        return out


def schedule_free(base_optimizer, learning_rate, b1: float = 0.9, weight_lr_power: float = 2.0,
                  state_dtype=None):
    """optax.contrib.schedule_free -> `params -> _ScheduleFree`."""
    return functools.partial(_ScheduleFree, base_optimizer=base_optimizer,
                             learning_rate=learning_rate, b1=b1, weight_lr_power=weight_lr_power,
                             state_dtype=state_dtype)


class _SubChain(_Step):
    """A chain inside a chain (optax.chain(add_decayed_weights, sgd)): its
    steps in turn, its state the inner chain's tuple."""

    def __init__(self, steps: List[_Step]):
        self.steps = steps

    def layout(self, rule) -> dict:
        return _chain([s.layout(rule) for s in self.steps])

    def __call__(self, rule, group, params, updates):
        for s in self.steps:
            updates = s(rule, group, params, updates)
        return updates


def schedule_free_adamw(learning_rate: float = 0.0025, warmup_steps: Optional[int] = None,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        weight_decay: float = 0.0, weight_lr_power: float = 2.0,
                        state_dtype=None):
    """optax.contrib.schedule_free_adamw: schedule_free around scale_by_rms
    (eps outside the root, bias-corrected), the decay and the learning
    rate (a linear warm-up from 0 with `warmup_steps`)."""
    if warmup_steps is not None:
        learning_rate = optim.warmup_constant_schedule(0, learning_rate, warmup_steps)
    base = _rule("schedule_free_adamw", learning_rate, lambda: [
        _ScaleByRms(b2, eps, 0.0, eps_in_sqrt=False, bias_correction=True),
        optim._AddDecayedWeights(weight_decay), optim._ScaleByLR(learning_rate)])
    return schedule_free(base, learning_rate, b1, weight_lr_power, state_dtype)


def schedule_free_sgd(learning_rate: float = 1.0, warmup_steps: Optional[int] = None,
                      b1: float = 0.9, weight_decay: Optional[float] = None,
                      weight_lr_power: float = 2.0, state_dtype=None):
    """optax.contrib.schedule_free_sgd: schedule_free around sgd (after the
    decay, with `weight_decay`)."""
    if warmup_steps is not None:
        learning_rate = optim.warmup_constant_schedule(0, learning_rate, warmup_steps)
    if weight_decay is None:
        base = optim.sgd(learning_rate)
    else:
        base = _rule("schedule_free_sgd", learning_rate, lambda: [
            optim._AddDecayedWeights(weight_decay),
            _SubChain([_Identity(), optim._ScaleByLR(learning_rate)])])
    return schedule_free(base, learning_rate, b1, weight_lr_power, state_dtype)


class _Mechanic(_Wrapper):
    """optax.contrib.mechanize: the base rule's update scaled by Mechanic's
    learned scale s (its sum over `num_betas` betas; r, m, v, s vectors on
    the device), from the first parameters x0."""

    _OWN = ("mech_count", "r", "m", "v", "s", "x0", "schedule_count")

    def __init__(self, params, base_optimizer: Callable, weight_decay: float = 0.01,
                 eps: float = 1e-8, s_init: float = 1e-6, num_betas: int = 6, schedule=None):
        super().__init__(params, base_optimizer, dict(mech_count=0), schedule)
        self.wd, self.eps, self.s_init, self.n = weight_decay, eps, s_init, num_betas
        self.betas = [1.0 - 0.1**i for i in range(1, num_betas + 1)]
        self._betas = None

    def _layout(self) -> dict:
        return {"base_optimizer_state": _Scope(self.inner), "count": _Group("mech_count"),
                "r": _Group("r", device=True), "m": _Group("m", device=True),
                "v": _Group("v", device=True), "s": _Group("s", device=True),
                "x0": _Param("x0")}

    def _prepare(self, device) -> None:
        super()._prepare(device)
        group = self.param_groups[0]
        if not torch.is_tensor(group["mech_count"]):
            group["mech_count"] = torch.full((), group["mech_count"], dtype=torch.int32,
                                             device=device)

    def _vector(self, key: str, start: float, device) -> torch.Tensor:
        group = self.param_groups[0]
        if key not in group:
            group[key] = torch.full((self.n,), start, device=device)
        elif group[key].device != device:
            group[key] = group[key].to(device)
        return group[key]

    def _update(self, group, params, grads):
        dev = params[0].device
        if self._betas is None or self._betas.device != dev:
            self._betas = torch.tensor(self.betas, dtype=torch.float32, device=dev)
        betas = self._betas
        r, m, v = (self._vector(k, 0.0, dev) for k in ("r", "m", "v"))
        s = self._vector("s", self.s_init, dev)
        count = group["mech_count"]
        x0 = self._state(params, "x0", lambda p: p.detach().clone())
        if torch.is_tensor(count):
            x0 = [torch.where(count == 0, p, x) for p, x in zip(params, x0)]
        elif count == 0:
            x0 = [p.detach().clone() for p in params]
        neg = self.inner.update(grads)
        s_sum = s.sum()
        grad_norm, param_norm = _sq_norm(grads).sqrt(), _sq_norm(params).sqrt()
        decayed = _axpy(grads, 1.0, params, self.wd * s_sum * grad_norm / (param_norm + self.eps))
        delta_prev = torch._foreach_sub(x0, params)
        torch._foreach_div_(delta_prev, s_sum + self.eps)
        h = _vdot(decayed, delta_prev)
        clipped = torch.minimum(torch.maximum(h, -m), m)
        m = torch.maximum(betas * m, h.abs() + self.eps)
        v = betas**2 * v + h**2
        r = betas * r + clipped * s
        wealth = self.s_init / self.n * m + torch.clamp_min(r, 0.0)
        s = wealth / (torch.sqrt(v) + self.eps)
        # x0 - sum(s) (delta_prev - neg) - p
        step = torch._foreach_sub(delta_prev, neg)
        torch._foreach_mul_(step, s.sum())
        out = torch._foreach_sub(x0, step)
        torch._foreach_sub_(out, params)
        for p, x in zip(params, x0):
            self.state[p]["x0"] = x
        group["r"], group["m"], group["v"], group["s"] = r, m, v, s
        group["mech_count"] = count + 1
        return out


def mechanize(base_optimizer, weight_decay: float = 0.01, eps: float = 1e-8, s_init: float = 1e-6,
              num_betas: int = 6):
    """optax.contrib.mechanize -> `params -> _Mechanic`."""
    return functools.partial(_Mechanic, base_optimizer=base_optimizer, weight_decay=weight_decay,
                             eps=eps, s_init=s_init, num_betas=num_betas)


class _SAM(optim._Combinator):
    """optax.contrib.sam (transparent mode): `sync_period - 1` adversarial
    steps of `adv_optimizer` (their updates negated), then one step of
    `optimizer` from the parameters cached at the period's first step. The
    step in the period is a Python int: the rule that optax's `pick_one`
    keeps is the one run. With `reset_state` the adversarial rule restarts
    at the end of each period (its state made anew at its next step)."""

    def __init__(self, params, optimizer: Callable, adv_optimizer: Callable,
                 sync_period: int = 2, reset_state: bool = True, opaque_mode: bool = False,
                 batch_axis_name=None, schedule=None):
        if sync_period < 1:
            raise ValueError("Synchronization period must be >= 1.")
        if opaque_mode:  # JAX's train step passes no grad_fn: optax's update raises this
            raise ValueError("grad_fn must be provided when opaque_mode=True.")
        super().__init__(params, {"steps_since_sync": 0}, schedule)
        self.sync, self.reset = sync_period, reset_state
        self.opt = self._child(optimizer, self._pairs(), "opt/")
        self.adv = self._child(adv_optimizer, self._pairs(), "adv/")
        # the adversarial rule's group entries as they start, by key below its prefix
        self._adv_start = {k[len(self.adv._prefix):]: v
                           for k, v in optim._group_entries(self.adv)}

    def _kids(self) -> list:
        return [self.opt, self.adv]

    def _layout(self) -> dict:
        return {"steps_since_sync": _Group("steps_since_sync"), "opt_state": _Scope(self.opt),
                "adv_state": _Scope(self.adv), "cache": _Param("cache")}

    def _restart_adv(self) -> None:
        for d, k in optim._state_entries(self.adv):
            del d[k]
        group = self._root.param_groups[0]
        for k, v in self._adv_start.items():
            group[self.adv._prefix + k] = v

    def _update(self, group, params, updates):
        sss = group["steps_since_sync"]
        if torch.is_tensor(sss):
            raise NotImplementedError(f"sam inside a wrapper that decides on the device "
                                      f"(apply_if_finite, MultiSteps' skips) ({optim._OTHER})")
        cache = self._state(params, "cache", lambda p: p.detach().clone())
        if sss == self.sync - 1:
            held = _copy(params)
            with torch.no_grad():
                torch._foreach_copy_(params, cache)
            try:
                opt = self.opt.update(updates)
            finally:
                with torch.no_grad():
                    torch._foreach_copy_(params, held)
            out = [c - p + u for c, p, u in zip(cache, params, opt)]
            if self.reset:
                self._restart_adv()
        else:
            out = torch._foreach_neg(self.adv.update(updates))
        if sss == 0:
            for p in params:
                self.state[p]["cache"] = p.detach().clone()
        group["steps_since_sync"] = (sss + 1) % self.sync
        return out


def sam(optimizer, adv_optimizer, sync_period: int = 2, reset_state: bool = True,
        opaque_mode: bool = False, batch_axis_name=None):
    """optax.contrib.sam -> `params -> _SAM`."""
    return functools.partial(_SAM, optimizer=optimizer, adv_optimizer=adv_optimizer,
                             sync_period=sync_period, reset_state=reset_state,
                             opaque_mode=opaque_mode, batch_axis_name=batch_axis_name)


class _SplitRealAndImaginary(_Wrapper):
    """optax.contrib.split_real_and_imaginary: its rule on the real and
    imaginary parts of complex leaves; the port's parameters are real, so
    the rule runs on them as they are."""

    _OWN = ("schedule_count",)

    def __init__(self, params, inner: Callable, schedule=None):
        super().__init__(params, inner, {}, schedule)

    def _layout(self) -> dict:
        return {"inner_state": _Scope(self.inner)}

    def _update(self, group, params, grads):
        return self.inner.update(grads)


def split_real_and_imaginary(inner):
    """optax.contrib.split_real_and_imaginary -> `params ->
    _SplitRealAndImaginary`."""
    return functools.partial(_SplitRealAndImaginary, inner=inner)
