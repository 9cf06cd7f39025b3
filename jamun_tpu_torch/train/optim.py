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

The rest of optax's rules (`adabelief` ... `yogi`, below the nine) are
chains of `_Step`s, one per `scale_by_*` transform optax composes them
from, in optax's order; the rules share the steps. Steps that read a whole
leaf (trust ratios, novograd's second moment, adafactor's factoring and
block RMS, sm3's per-axis accumulators) see flax's leaves: `bind` names a
scanned E3Conv's `_HiddenLayer_k` slices by their flax leaf
(`Scan_HiddenLayer_0.<path>`, `params.flax_names`), and a leaf of several
slices is reduced, or stacked, as one.

Every optimizer here is a `_Node`: `update(updates)` is optax's update (the
new updates, no apply), `step()` applies it. `MultiSteps` and
`apply_if_finite` wrap any node; the combinators of
`train/optim_transforms.py` and the wrappers of `train/optim_contrib.py`
compose them. A node inside another keeps its state in the outermost one's
group and state under a prefix (`_attach`), so one state dict holds all.

Every rule declares optax's state tree (`jax_state_layout`): the entries of
the chain, each field and the port's state key it goes to, and where the
count lives (`params.load_jax_train_state` walks it).

A parameter without a gradient gets the update of a zero gradient, as every
leaf does in optax. Step counts are Python ints in the parameter group, so
a step makes no host wait and the state dict loads with `weights_only`.
Under `apply_if_finite` and `MultiSteps` the counts are device tensors
(whether a step counts is device data, `_guarded`): the bias corrections
and schedules read them on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

RULES = (
    "adam", "adamw", "adagrad", "nadam", "nadamw", "adamax", "lion", "sgd", "rmsprop",
    "adabelief", "adadelta", "adafactor", "adamaxw", "adan", "amsgrad", "fromage", "lamb",
    "lars", "noisy_sgd", "novograd", "optimistic_adam", "optimistic_adam_v2",
    "optimistic_gradient_descent", "radam", "rprop", "sign_sgd", "sm3", "yogi",
)
SCHEDULES = (
    "constant_schedule", "linear_schedule", "cosine_decay_schedule",
    "warmup_cosine_decay_schedule", "exponential_decay", "cosine_onecycle_schedule",
    "join_schedules", "linear_onecycle_schedule", "piecewise_constant_schedule",
    "piecewise_interpolate_schedule", "polynomial_schedule", "sgdr_schedule",
    "warmup_constant_schedule", "warmup_exponential_decay_schedule",
)
WRAPPERS = ("MultiSteps", "apply_if_finite")

__all__ = [
    *RULES, *SCHEDULES, *WRAPPERS,
    "Adam", "Adagrad", "Adamax", "Lion", "SGD", "RMSProp", "bind",
]


_OTHER = "ROADMAP.md queue A, 'Other config targets'"


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


def _tree_values(tree, names: Optional[List[str]], params: List[torch.Tensor], what: str = "a mask"
                 ) -> list:
    """An optax tree of one value per leaf (a tree keyed by the flax names,
    a prefix of it, or a callable of the parameter tree that returns one)
    as one value per parameter. The tree is JAX's parameter tree,
    {"params": {...}}; a tree without the "params" level is read from the
    level below it."""
    if names is None:
        raise ValueError(
            f"{what} is keyed by the parameters' names: bind the optimizer to "
            "module.named_parameters()"
        )
    if callable(tree):  # called on the flax tree: a scanned leaf's slices stacked
        by_name: dict = {}
        for name, p in zip(names, params):
            by_name.setdefault(name, []).append(p)
        built: dict = {}
        for name, ps in by_name.items():
            node = built.setdefault("params", {})
            *path, leaf = name.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = ps[0] if len(ps) == 1 else torch.stack([p.detach() for p in ps])
        tree = tree(built)
    out = []
    for name in names:
        node = tree.get("params", tree) if isinstance(tree, dict) else tree
        for key in name.split("."):
            if not isinstance(node, dict):
                break
            node = node[key]
        out.append(node)
    return out


def _mask_of(mask, names: Optional[List[str]], params: List[torch.Tensor]) -> Optional[List[bool]]:
    """optax's `mask` (a tree of bools keyed by the flax names, a prefix of
    it, or a callable of the parameter tree that returns one) as one bool
    per parameter (`_tree_values`)."""
    if mask is None:
        return None
    return [bool(v) for v in _tree_values(mask, names, params)]


# ---- the places of optax's state tree (`jax_state_layout`) ----


class _Slot:
    """A leaf of a rule's optax state layout: what the walk of
    `params.load_jax_train_state` does with the JAX value found there."""


class _Count(_Slot):
    """An int32 step count: the rule's (every such place must agree), or
    with `outer` the chained `scale_by_schedule`'s; with `mod`, optax keeps
    the count modulo `mod` (apply_every) and the rule's count is found
    elsewhere."""

    def __init__(self, outer: bool = False, mod: Optional[int] = None):
        self.outer, self.mod = outer, mod


class _Param(_Slot):
    """A tree of the parameters' shapes: each parameter's slice goes to its
    state under `key`."""

    def __init__(self, key: str):
        self.key = key


class _Leaf(_Slot):
    """A tree with one entry per flax leaf: `place(rule, leaf, value)`,
    `leaf` the index into `rule._leaves()`, `value` a tensor (or sm3's
    dict of them)."""

    def __init__(self, place: Callable):
        self.place = place


class _Group(_Slot):
    """A scalar kept in the parameter group under `key`: a Python int, or
    with `device` a tensor on the parameters' device."""

    def __init__(self, key: str, device: bool = False):
        self.key, self.device = key, device


class _Custom(_Slot):
    """A value placed as it is: `place(node, tensor)`."""

    def __init__(self, place: Callable):
        self.place = place


class _Initial(_Slot):
    """optax's `is_initial_step`: the port reads it off the count."""


class _Unused(_Slot):
    """A value the port does not carry: noisy_sgd's JAX key (a torch
    generator cannot take it), and the count of a scheduled weight decay,
    which optax 0.2.6 never advances."""


def _chain(entries) -> dict:
    """A tuple of optax states as flax stores it: keyed "0", "1", ..."""
    return {str(i): e for i, e in enumerate(entries)}


def _lr_layout(lr) -> dict:
    """`scale_by_learning_rate`: a schedule keeps its count, a float
    nothing."""
    return {"count": _Count()} if callable(lr) else {}


def _decay_layout(weight_decay, mask) -> dict:
    """`add_decayed_weights`, wrapped in `masked` when a mask is given."""
    inner = {"count": _Unused()} if callable(weight_decay) else {}
    return inner if mask is None else {"inner_state": inner}


def _named(params) -> tuple:
    """(names or None, tensors) of a parameter list: tensors, or the (name,
    tensor) pairs of `named_parameters()`."""
    params = list(params)
    if params and isinstance(params[0], tuple):
        return [n for n, _ in params], [p for _, p in params]
    return None, params


# ---- one storage for a rule and the rules inside it ----
#
# A wrapper or combinator builds the rules inside it as optimizers of their
# own over their parameters, then moves their storage into its own under a
# prefix (`_attach`): their group entries go to the outer group as
# `<prefix><key>`, their state to `state[p]["<prefix><key>"]`, so that the
# outermost optimizer's `state_dict()` holds every rule's state and counts.
# The views below look the outermost optimizer up at every access, so they
# stay right after its `load_state_dict`.


class _GroupView:
    """A nested rule's parameter group: its keys under its prefix in the
    outermost group, "params" its own parameters."""

    def __init__(self, node):
        self.node = node

    def _key(self, key: str) -> str:
        return self.node._prefix + key

    def __getitem__(self, key: str):
        if key == "params":
            return self.node._params
        return self.node._root.param_groups[0][self._key(key)]

    def __setitem__(self, key: str, value) -> None:
        self.node._root.param_groups[0][self._key(key)] = value

    def __contains__(self, key: str) -> bool:
        return key == "params" or self._key(key) in self.node._root.param_groups[0]

    def get(self, key: str, default=None):
        return self[key] if key in self else default


class _PrefixedDict:
    """A nested rule's state of one parameter: its keys under its prefix."""

    def __init__(self, store: dict, prefix: str):
        self.store, self.prefix = store, prefix

    def __getitem__(self, key: str):
        return self.store[self.prefix + key]

    def __setitem__(self, key: str, value) -> None:
        self.store[self.prefix + key] = value

    def __contains__(self, key: str) -> bool:
        return self.prefix + key in self.store


class _StateView:
    """A nested rule's `state`: per parameter a `_PrefixedDict` into the
    outermost optimizer's state (a parameter that only `flatten` makes is
    kept on a real one: the outermost node's `_alias`)."""

    def __init__(self, node):
        self.node = node

    def where(self, p) -> tuple:
        """(the outermost optimizer's parameter, the full key prefix)."""
        return self.node._root._alias.get(id(p), p), self.node._prefix

    def __getitem__(self, p):
        if isinstance(p, str):  # a rule's own entry (noisy_sgd's generator)
            return self.node._root.state[self.node._prefix + p]
        real, prefix = self.where(p)
        return _PrefixedDict(self.node._root.state[real], prefix)

    def __setitem__(self, key: str, value) -> None:
        self.node._root.state[self.node._prefix + key] = value

    def __contains__(self, p) -> bool:
        return self.node._prefix + p in self.node._root.state if isinstance(p, str) else True


# apply_if_finite and MultiSteps' skips: each state entry a guarded update
# makes, by (id of its parameter's state dict, full key), with its first value
_FRESH: Optional[dict] = None

# the group keys that count steps: Python ints, or int32 device tensors where a
# guarded update decides on the device whether a step counts
_COUNTERS = ("count", "mini_step", "gradient_step", "steps_since_sync", "step")


class _Node(torch.optim.Optimizer):
    """An optimizer of this module: one of optax's rules, wrappers or
    combinators. `update(updates)` is optax's update on the node's
    parameters as they stand (it advances the node's counts and returns the
    new updates); `step()` applies it, scaled by a chained `schedule`.
    `_layout()` is optax's state tree of the node; `_kids()` the nodes
    inside it, each with its prefix (module comment above)."""

    _OWN: tuple = ()  # a wrapper's own group and state keys, beside its rule's

    def _init_node(self, params, names) -> None:
        self.names = names
        self._params = params
        self._root, self._prefix, self._alias = self, "", {}
        self._reserved: frozenset = frozenset()
        self._leaf_index = None

    # ---- the update protocol ----

    def _update(self, group, params, updates) -> List[torch.Tensor]:
        raise NotImplementedError(f"{type(self).__name__} has no update ({_OTHER})")

    def update(self, updates: List[torch.Tensor]) -> List[torch.Tensor]:
        group = self.param_groups[0]
        out = self._update(group, group["params"], updates)
        self._advance(group)
        return out

    def _advance(self, group) -> None:
        group["count"] = group["count"] + 1

    def _schedule_count(self, group):
        return group["count"]

    @torch.no_grad()
    def step(self, closure=None):
        """p = p + schedule(c) * update(g), c the count before the step."""
        group = self.param_groups[0]
        params = group["params"]
        at = self._schedule_count(group)
        updates = self.update(_grads(params))
        if self.schedule is not None:
            torch._foreach_mul_(updates, float(self.schedule(at)))
        torch._foreach_add_(params, updates)

    def _kids(self) -> list:
        """The nodes inside this one."""
        return []

    def _child(self, factory: Callable, named: list, prefix: str):
        """`factory` bound to `named` (a sub-list of this node's (name,
        parameter) pairs), its storage moved into this node's under
        `prefix`."""
        kid = factory(named)
        if not isinstance(kid, _Node):
            raise NotImplementedError(
                f"{type(self).__name__} around {type(kid).__name__}: the port composes optax's "
                f"rules of this module ({_OTHER})")
        _attach(kid, self, prefix)
        return kid

    def _prepare(self, device) -> None:
        """Every count of this node and the nodes inside it as an int32
        tensor on `device`, before an update that the device guards."""
        group = self.param_groups[0]
        for key in _COUNTERS:
            if key in group and key not in self._reserved:
                v = group[key]
                if not torch.is_tensor(v):
                    group[key] = torch.full((), v, dtype=torch.int32, device=device)
                elif v.device != device:
                    group[key] = v.to(device)
        for kid in self._kids():
            kid._prepare(device)

    # ---- state ----

    def _state(self, params, name: str, make) -> List[torch.Tensor]:
        for p in params:
            if name not in self.state[p]:
                self.state[p][name] = make(p)
                if _FRESH is not None:
                    real, prefix = (self.state.where(p) if isinstance(self.state, _StateView)
                                    else (p, ""))
                    _FRESH[(id(self._root.state[real]), prefix + name)] = (
                        self.state[p][name].clone())
        return [self.state[p][name] for p in params]

    def _scalar(self, key: str, device, start: Optional[float] = None) -> torch.Tensor:
        """A tree-wide f32 scalar kept in the group (`start` before the first
        step), as a tensor on `device` (made by a fill where it is still the
        Python number of its start)."""
        group = self.param_groups[0]
        if key not in group:
            group[key] = start
        v = group[key]
        if not torch.is_tensor(v):
            v = torch.full((), v, dtype=torch.float32, device=device)
        elif v.device != device:
            v = v.to(device)
        group[key] = v
        return v

    # ---- flax's leaves (module docstring) ----

    def _leaves(self) -> List[List[int]]:
        """The parameters' indices by flax leaf, in order: one each, except
        the slices of a scanned layer stack, which share their leaf's name."""
        if self._leaf_index is None:
            params = self.param_groups[0]["params"]
            names = self.names or [str(i) for i in range(len(params))]
            by_name: dict = {}
            for i, n in enumerate(names):
                by_name.setdefault(n, []).append(i)
            self._leaf_index = list(by_name.values())
        return self._leaf_index

    def leaf_names(self) -> List[str]:
        names = self.names or [str(i) for i in range(len(self.param_groups[0]["params"]))]
        return [names[idx[0]] for idx in self._leaves()]

    def _mask_list(self, mask, params) -> List[bool]:
        """optax's mask as one bool per parameter (True: all)."""
        if mask is None or mask is True:
            return [True] * len(params)
        if mask is False:
            return [False] * len(params)
        return _mask_of(mask, self.names, params)

    # ---- optax's state tree (module docstring) ----

    def _layout(self) -> dict:
        raise NotImplementedError(f"{type(self).__name__} declares no optax state ({_OTHER})")

    def _schedule_slot(self) -> _Slot:
        return _Count(outer=True)

    def jax_state_layout(self) -> dict:
        """optax's state tree of this rule as JAX's trainer builds it, each
        place marked with where it goes (`_Slot`); with a chained schedule
        the chain {"0": rule, "1": scale_by_schedule}."""
        own = self._layout()
        if self.schedule is not None:
            return {"0": own, "1": {"count": self._schedule_slot()}}
        return own


class _Scope(_Slot):
    """The state tree of a node inside another: its slots place into that
    node's parameters and group."""

    def __init__(self, node: _Node):
        self.node, self.layout = node, node._layout()


def _attach(kid: _Node, parent: _Node, prefix: str, reserved=()) -> None:
    """`kid`'s group entries and state into `parent`'s storage under
    `prefix` (relative to `parent`'s), and `kid` and the nodes inside it
    reading them there from now on."""
    root, full = parent._root, parent._prefix + prefix
    group = kid.param_groups[0]
    if not isinstance(group, _GroupView):  # a fresh node: its own storage
        for key, value in group.items():
            if key != "params":
                root.param_groups[0][full + key] = value
        for p, entries in kid.state.items():
            for key, value in entries.items():
                root.state[p][full + key] = value
    root._alias.update(kid._alias)
    _repoint(kid, root, full)
    kid._reserved = frozenset(reserved)
    kid.param_groups, kid.state = [_GroupView(kid)], _StateView(kid)
    kid.schedule = None


def _repoint(node: _Node, root: _Node, prefix: str) -> None:
    old = node._prefix
    node._root, node._prefix = root, prefix
    for kid in node._kids():
        _repoint(kid, root, prefix + kid._prefix[len(old):])


class _OptaxRule(_Node):
    """`learning_rate` a float or a schedule (step -> value); `schedule` a
    multiplier chained after the rule; `mask` for the decoupled decay."""

    def __init__(self, params, defaults: dict, schedule: Optional[Callable[[int], float]],
                 mask=None):
        names, params = _named(params)
        lr = defaults.pop("lr")
        self.lr_schedule = lr if callable(lr) else None
        super().__init__(params, dict(defaults, lr=None if callable(lr) or lr is None else float(lr),
                                      count=0))
        self._init_node(params, names)
        self.schedule = schedule
        self.decay_mask = _mask_of(mask, names, params)

    def _lr(self, group: dict):
        if self.lr_schedule is not None:
            return _value(self.lr_schedule(group["count"]))
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


def _value(v):
    """A schedule's value: a float for a host count, the tensor for a
    device count."""
    return v if torch.is_tensor(v) else float(v)


def _weak(x: float, t: torch.Tensor) -> float:
    """x rounded to t's dtype, as JAX's weak typing rounds a Python scalar
    that multiplies a bf16 array."""
    return _rounded(x, t.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))  # a host tensor, once per value


def _moment(grads, moments, decay: float) -> List[torch.Tensor]:
    """(1 - decay) g + decay m, decay m in m's dtype (`_weak`), the sum in
    the promoted dtype."""
    return [(1 - decay) * g + _weak(decay, m) * m for g, m in zip(grads, moments)]


class Adam(_OptaxRule):
    """`optax.adam`, `adamw` with `weight_decay` (and `mask`), `nadam` /
    `nadamw` with `nesterov`; the first moment kept in `mu_dtype`."""

    def __init__(
        self, params: Iterable[torch.Tensor], lr, b1: float = 0.9, b2: float = 0.999,
        eps: float = 1e-8, eps_root: float = 0.0, weight_decay: Optional[float] = None,
        schedule: Optional[Callable[[int], float]] = None, mu_dtype=None, nesterov: bool = False,
        mask=None,
    ):
        super().__init__(
            params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay,
                         nesterov=nesterov),
            schedule, mask,
        )
        self.mu_dtype = _dtype(mu_dtype)

    def _layout(self) -> dict:
        # adamw / nadamw (a weight decay given, 0 too) chain add_decayed_weights
        wd = self.param_groups[0]["weight_decay"]
        decay = [] if wd is None else [_decay_layout(wd, self.decay_mask)]
        return _chain([{"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}, *decay,
                       _lr_layout(self.lr_schedule)])

    def _update(self, group, params, grads):
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
            updates = _nesterov_hat(new_mu, grads, b1, t)
        else:
            updates = torch._foreach_div(new_mu, _bias(b1, t))
        denom = torch._foreach_div(nu, _bias(b2, t))
        torch._foreach_add_(denom, group["eps_root"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(updates, denom)
        if self.mu_dtype is not None:
            for p, m in zip(params, new_mu):
                self.state[p]["mu"] = m.to(self.mu_dtype)
        self._decay(group, params, updates)
        self._scale_by_lr(group, updates)
        return updates


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

    def _layout(self) -> dict:
        return _chain([{"sum_of_squares": _Param("sum_of_squares")}, _lr_layout(self.lr_schedule)])

    def _update(self, group, params, grads):
        acc = self._state(
            params, "sum_of_squares",
            lambda p: torch.full_like(p, group["initial_accumulator_value"]),
        )
        torch._foreach_addcmul_(acc, grads, grads)
        inv = torch._foreach_add(acc, group["eps"])
        torch._foreach_rsqrt_(inv)
        updates = [torch.where(a > 0, r, 0.0) * g for a, r, g in zip(acc, inv, grads)]
        self._scale_by_lr(group, updates)
        return updates


class Adamax(_OptaxRule):
    """`optax.adamax`."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps), schedule)

    def _layout(self) -> dict:
        return _chain([{"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")},
                       _lr_layout(self.lr_schedule)])

    def _update(self, group, params, grads):
        mu = self._state(params, "mu", torch.zeros_like)
        nu = self._state(params, "nu", torch.zeros_like)
        b1, b2, t = group["b1"], group["b2"], group["count"] + 1
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        for n, g in zip(nu, grads):
            torch.maximum(g.abs() + group["eps"], b2 * n, out=n)
        updates = torch._foreach_div(mu, _bias(b1, t))
        torch._foreach_div_(updates, nu)
        self._scale_by_lr(group, updates)
        return updates


class Lion(_OptaxRule):
    """`optax.lion`: the sign of the interpolated momentum, decoupled decay
    (`mask`), the momentum kept in `mu_dtype`."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.99, mu_dtype=None,
                 weight_decay: float = 1e-3, mask=None,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay), schedule, mask)
        self.mu_dtype = _dtype(mu_dtype)

    def _layout(self) -> dict:
        return _chain([{"count": _Count(), "mu": _Param("mu")},
                       _decay_layout(self.param_groups[0]["weight_decay"], self.decay_mask),
                       _lr_layout(self.lr_schedule)])

    def _update(self, group, params, grads):
        mu = self._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
        b1, b2 = group["b1"], group["b2"]
        updates = [torch.sign(v) for v in _moment(grads, mu, b1)]
        for p, m in zip(params, _moment(grads, mu, b2)):
            self.state[p]["mu"] = m.to(self.mu_dtype or m.dtype)
        self._decay(group, params, updates)
        self._scale_by_lr(group, updates)
        return updates


def _trace(rule: _Node, params, updates, m: float, nesterov: bool, dtype) -> List[torch.Tensor]:
    """optax's `trace`: tr = u + m tr (kept in `dtype`); returns tr, or
    u + m tr with nesterov."""
    tr = rule._state(params, "trace", lambda p: torch.zeros_like(p, dtype=dtype))
    new = [u + _weak(m, t) * t for u, t in zip(updates, tr)]
    out = [u + m * t for u, t in zip(updates, new)] if nesterov else new
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

    def _layout(self) -> dict:
        trace = {} if self.param_groups[0]["momentum"] is None else {"trace": _Param("trace")}
        return _chain([trace, _lr_layout(self.lr_schedule)])

    def _update(self, group, params, grads):
        updates = [g.clone() for g in grads]
        if group["momentum"] is not None:
            updates = _trace(self, params, updates, group["momentum"], group["nesterov"],
                             self.accumulator_dtype)
        self._scale_by_lr(group, updates)
        return updates


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

    def _layout(self) -> dict:
        g = self.param_groups[0]
        rms = {"count": _Count()} if g["bias_correction"] else {}
        if g["centered"]:
            rms["mu"] = _Param("mu")
        rms["nu"] = _Param("nu")
        trace = {} if g["momentum"] is None else {"trace": _Param("trace")}
        return _chain([rms, _lr_layout(self.lr_schedule), trace])

    def _update(self, group, params, grads):
        d, t = group["decay"], group["count"] + 1
        nu = self._state(params, "nu", lambda p: torch.full_like(p, group["initial_scale"]))
        torch._foreach_mul_(nu, d)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - d)
        corr = _bias(d, t) if group["bias_correction"] else 1.0
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
            updates = _trace(self, params, updates, group["momentum"], group["nesterov"], None)
        return updates


# ---- the transform layer: optax's `scale_by_*` steps on flat lists ----
#
# A rule below is a `_Chain` of steps in optax's order. A step takes the
# updates (one tensor per parameter), returns the new ones and keeps its
# state in `rule.state[p]`; per flax leaf state sits on the leaf's first
# parameter. `group["count"]` is the number of updates made before this one
# (a Python int, or a device tensor under `apply_if_finite`), so t = count + 1
# in the bias corrections.


def _copy(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return torch._foreach_mul(tensors, 1.0)


# tree-wide sums (optax.tree's norms and dot products): a few device ops over
# every tensor at once, 0-d tensors on the tensors' device, in a fixed order


def _sq_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The squared L2 norm of every entry of `tensors` (optax's global
    norm, squared)."""
    return torch.stack(torch._foreach_norm(tensors)).square().sum()


def _l1(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the absolute values of every entry."""
    return torch.stack(torch._foreach_norm(tensors, ord=1)).sum()


def _vdot(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    """optax.tree.vdot: the sum over the tensors of their dot products."""
    return torch.cat([t.reshape(-1) for t in torch._foreach_mul(a, b)]).sum()


def _axpy(x: List[torch.Tensor], a, y: List[torch.Tensor], b) -> List[torch.Tensor]:
    """a x + b y, a new list (a and b floats or 0-d tensors)."""
    out = torch._foreach_mul(x, a)
    torch._foreach_add_(out, torch._foreach_mul(y, b))
    return out


def _ema_(moments, updates, decay: float) -> None:
    """moments = (1 - decay) u + decay moments (`update_moment`, order 1)."""
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, updates, alpha=1 - decay)


def _ema_sq_(moments, updates, decay: float) -> None:
    """moments = (1 - decay) u^2 + decay moments (order 2)."""
    torch._foreach_mul_(moments, decay)
    torch._foreach_addcmul_(moments, updates, updates, value=1 - decay)


def _ipow(x: float, n: int):
    """x^n in f32 by repeated squaring, as XLA raises a float to an int32
    count (optax's `decay**count`); a device count takes torch's pow."""
    if torch.is_tensor(n):
        return x ** n.to(torch.float32)
    out, base = _f32(1), _f32(x)
    while n:
        if n & 1:
            out = out * base
        base, n = base * base, n >> 1
    return out


def _bias(decay: float, t):
    """1 - decay^t in f32: a float for a host count, a tensor for a device
    one."""
    b = 1 - _ipow(decay, t)
    return b if torch.is_tensor(b) else float(b)


def _select(cond, a: List[torch.Tensor], b: List[torch.Tensor]) -> List[torch.Tensor]:
    """cond ? a : b, leaf by leaf: a host bool picks a list, a device bool
    `torch.where`s each pair."""
    if torch.is_tensor(cond):
        return [torch.where(cond, x, y) for x, y in zip(a, b)]
    return a if cond else b


def _nesterov_hat(mu, grads, b1: float, t):
    """b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)."""
    out = torch._foreach_div(mu, _bias(b1, t + 1))
    torch._foreach_mul_(out, b1)
    torch._foreach_add_(out, torch._foreach_mul(torch._foreach_div(grads, _bias(b1, t)), 1 - b1))
    return out


def _leaf_norms(rule, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The L2 norm of each flax leaf (the norm of the stacked leaf for a
    scanned one), 0-d tensors on the tensors' device."""
    norms = torch._foreach_norm(tensors)
    return [norms[idx[0]] if len(idx) == 1
            else torch.stack([norms[i] for i in idx]).square().sum().sqrt()
            for idx in rule._leaves()]


def _leaf_rms(rule, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """sqrt(mean(x^2)) of each flax leaf: its norm over sqrt(size)."""
    sizes = [sum(tensors[i].numel() for i in idx) for idx in rule._leaves()]
    return torch._foreach_mul(_leaf_norms(rule, tensors), [1 / math.sqrt(n) for n in sizes])


def _per_param(rule, per_leaf) -> List[torch.Tensor]:
    """One value per flax leaf (a list, or a vector) as one per parameter."""
    rows = per_leaf.unbind() if torch.is_tensor(per_leaf) else per_leaf
    out = [None] * len(rule.param_groups[0]["params"])
    for leaf, idx in enumerate(rule._leaves()):
        for i in idx:
            out[i] = rows[leaf]
    return out


def _stacked(tensors: List[torch.Tensor], idx: List[int]) -> torch.Tensor:
    """The flax leaf of parameters `idx`: itself, or the scanned slices
    stacked on a new leading axis."""
    return tensors[idx[0]] if len(idx) == 1 else torch.stack([tensors[i] for i in idx])


class _Step:
    """One optax transform: `layout(rule)` its state in optax's tree, the
    call its update."""

    def layout(self, rule) -> dict:
        return {}

    def __call__(self, rule, group, params, updates):
        raise NotImplementedError(f"{type(self).__name__} has no update ({_OTHER})")


class _Scale(_Step):
    """optax.scale."""

    def __init__(self, step_size: float):
        self.step_size = step_size

    def __call__(self, rule, group, params, updates):
        torch._foreach_mul_(updates, self.step_size)
        return updates


class _ScaleByLR(_Step):
    """optax.scale_by_learning_rate: -lr (or +lr with `flip_sign=False`),
    lr a float or a schedule read at the rule's count; None is identity."""

    def __init__(self, learning_rate, flip_sign: bool = True):
        self.lr, self.sign = learning_rate, -1 if flip_sign else 1

    def layout(self, rule) -> dict:
        return _lr_layout(self.lr)

    def __call__(self, rule, group, params, updates):
        if self.lr is None:
            return updates
        lr = _value(self.lr(group["count"])) if callable(self.lr) else self.lr
        torch._foreach_mul_(updates, self.sign * lr)
        return updates


class _AddDecayedWeights(_Step):
    """optax.add_decayed_weights: u + weight_decay * p where `mask` allows.
    A schedule as weight decay is read at count 0: optax 0.2.6 never
    advances that count."""

    def __init__(self, weight_decay, mask=None):
        self.weight_decay, self.mask = weight_decay, mask

    def layout(self, rule) -> dict:
        return _decay_layout(self.weight_decay, self.mask)

    def __call__(self, rule, group, params, updates):
        wd = _value(self.weight_decay(0)) if callable(self.weight_decay) else self.weight_decay
        keep = rule._mask_list(self.mask, params)
        us = [u for u, k in zip(updates, keep) if k]
        if us:
            torch._foreach_add_(us, torch._foreach_mul([p for p, k in zip(params, keep) if k], wd))
        return updates


class _Trace(_Step):
    """optax.trace: tr = u + decay tr; u = tr, or u + decay tr (nesterov);
    the trace kept in `accumulator_dtype`."""

    def __init__(self, decay: float, nesterov: bool = False, accumulator_dtype=None):
        self.decay, self.nesterov, self.dtype = decay, nesterov, _dtype(accumulator_dtype)

    def layout(self, rule) -> dict:
        return {"trace": _Param("trace")}

    def __call__(self, rule, group, params, updates):
        if self.dtype is not None:
            return _trace(rule, params, updates, self.decay, self.nesterov, self.dtype)
        tr = rule._state(params, "trace", torch.zeros_like)
        torch._foreach_mul_(tr, self.decay)
        torch._foreach_add_(tr, updates)
        if not self.nesterov:
            return _copy(tr)
        return torch._foreach_add(updates, torch._foreach_mul(tr, self.decay))


class _ScaleByAdam(_Step):
    """optax.scale_by_adam (lamb, optimistic_adam): Adam's moments, the
    first kept in `mu_dtype`, nesterov's estimate."""

    def __init__(self, b1, b2, eps, eps_root, mu_dtype=None, nesterov=False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype, self.nesterov = _dtype(mu_dtype), nesterov

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}

    def __call__(self, rule, group, params, grads):
        b1, b2, t = self.b1, self.b2, group["count"] + 1
        mu = rule._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
        nu = rule._state(params, "nu", torch.zeros_like)
        if self.mu_dtype is None:
            _ema_(mu, grads, b1)
            new_mu = mu
        else:
            new_mu = _moment(grads, mu, b1)
        _ema_sq_(nu, grads, b2)
        hat = (_nesterov_hat(new_mu, grads, b1, t) if self.nesterov
               else torch._foreach_div(new_mu, _bias(b1, t)))
        denom = torch._foreach_div(nu, _bias(b2, t))
        torch._foreach_add_(denom, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(hat, denom)
        if self.mu_dtype is not None:
            for p, m in zip(params, new_mu):
                rule.state[p]["mu"] = m.to(self.mu_dtype)
        return hat


class _ScaleByBelief(_Step):
    """optax.scale_by_belief (adabelief): nu tracks (g - mu)^2 + eps_root."""

    def __init__(self, b1, b2, eps, eps_root, nesterov=False):
        self.b1, self.b2, self.eps, self.eps_root, self.nesterov = b1, b2, eps, eps_root, nesterov

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}

    def __call__(self, rule, group, params, grads):
        b1, b2, t = self.b1, self.b2, group["count"] + 1
        mu = rule._state(params, "mu", torch.zeros_like)
        nu = rule._state(params, "nu", torch.zeros_like)
        _ema_(mu, grads, b1)
        _ema_sq_(nu, torch._foreach_sub(grads, mu), b2)
        torch._foreach_add_(nu, self.eps_root)
        hat = (_nesterov_hat(mu, grads, b1, t) if self.nesterov
               else torch._foreach_div(mu, _bias(b1, t)))
        denom = torch._foreach_div(nu, _bias(b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(hat, denom)
        return hat


class _ScaleByAdadelta(_Step):
    """optax.scale_by_adadelta."""

    def __init__(self, rho, eps):
        self.rho, self.eps = rho, eps

    def layout(self, rule) -> dict:
        return {"e_g": _Param("e_g"), "e_x": _Param("e_x")}

    def __call__(self, rule, group, params, grads):
        e_g = rule._state(params, "e_g", torch.zeros_like)
        e_x = rule._state(params, "e_x", torch.zeros_like)
        _ema_sq_(e_g, grads, self.rho)
        num = torch._foreach_add(e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(num, grads)
        _ema_sq_(e_x, num, self.rho)
        return num


class _ScaleByAdamax(_Step):
    """optax.scale_by_adamax (adamaxw)."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}

    def __call__(self, rule, group, params, grads):
        t = group["count"] + 1
        mu = rule._state(params, "mu", torch.zeros_like)
        nu = rule._state(params, "nu", torch.zeros_like)
        _ema_(mu, grads, self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_maximum_(nu, torch._foreach_add(torch._foreach_abs(grads), self.eps))
        out = torch._foreach_div(mu, _bias(self.b1, t))
        torch._foreach_div_(out, nu)
        return out


class _ScaleByAdan(_Step):
    """optax.scale_by_adan: the gradient's difference from the last one
    (zero on the first step), its moment and the moment of
    (g + (1 - b2) diff)^2; optax's own count is `t`."""

    def __init__(self, b1, b2, b3, eps, eps_root):
        self.b1, self.b2, self.b3, self.eps, self.eps_root = b1, b2, b3, eps, eps_root

    def layout(self, rule) -> dict:
        return {"m": _Param("m"), "v": _Param("v"), "n": _Param("n"), "g": _Param("g"),
                "t": _Count()}

    def __call__(self, rule, group, params, grads):
        b1, b2, b3, count = self.b1, self.b2, self.b3, group["count"]
        m, v, n, prev = (rule._state(params, k, torch.zeros_like) for k in ("m", "v", "n", "g"))
        diff = torch._foreach_sub(grads, prev)
        if torch.is_tensor(count):
            diff = [torch.where(count == 0, 0.0, d) for d in diff]
        elif count == 0:
            torch._foreach_mul_(diff, 0.0)
        _ema_(m, grads, b1)
        _ema_(v, diff, b2)
        sq = torch._foreach_add(grads, torch._foreach_mul(diff, 1 - b2))
        _ema_sq_(n, sq, b3)
        t = count + 1
        u = torch._foreach_div(m, _bias(b1, t))
        torch._foreach_add_(u, torch._foreach_mul(torch._foreach_div(v, _bias(b2, t)), 1 - b2))
        denom = torch._foreach_div(n, _bias(b3, t))
        torch._foreach_add_(denom, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(u, denom)
        for p, g in zip(params, grads):  # the rule's own copy of the gradient
            rule.state[p]["g"] = g
        return u


class _ScaleByAmsgrad(_Step):
    """optax.scale_by_amsgrad: the largest bias-corrected nu so far."""

    def __init__(self, b1, b2, eps, eps_root, mu_dtype=None):
        self.b1, self.b2, self.eps, self.eps_root, self.mu_dtype = b1, b2, eps, eps_root, _dtype(mu_dtype)

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu"),
                "nu_max": _Param("nu_max")}

    def __call__(self, rule, group, params, grads):
        b1, b2, t = self.b1, self.b2, group["count"] + 1
        mu = rule._state(params, "mu", lambda p: torch.zeros_like(p, dtype=self.mu_dtype))
        nu = rule._state(params, "nu", torch.zeros_like)
        nu_max = rule._state(params, "nu_max", torch.zeros_like)
        if self.mu_dtype is None:
            _ema_(mu, grads, b1)
            new_mu = mu
        else:
            new_mu = _moment(grads, mu, b1)
        _ema_sq_(nu, grads, b2)
        hat = torch._foreach_div(new_mu, _bias(b1, t))
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, _bias(b2, t)))
        denom = torch._foreach_add(nu_max, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(hat, denom)
        if self.mu_dtype is not None:
            for p, m in zip(params, new_mu):
                rule.state[p]["mu"] = m.to(self.mu_dtype)
        return hat


class _ScaleByYogi(_Step):
    """optax.scale_by_yogi: nu -= (1 - b2) sign(nu - g^2) g^2, both moments
    from `initial_accumulator_value`."""

    def __init__(self, b1, b2, eps, eps_root=0.0, initial_accumulator_value=1e-6):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.init = initial_accumulator_value

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}

    def __call__(self, rule, group, params, grads):
        t = group["count"] + 1
        mu = rule._state(params, "mu", lambda p: torch.full_like(p, self.init))
        nu = rule._state(params, "nu", lambda p: torch.full_like(p, self.init))
        _ema_(mu, grads, self.b1)
        sq = torch._foreach_mul(grads, grads)
        step = torch._foreach_sign(torch._foreach_sub(nu, sq))
        torch._foreach_mul_(step, 1 - self.b2)
        torch._foreach_mul_(step, sq)
        torch._foreach_sub_(nu, step)
        hat = torch._foreach_div(mu, _bias(self.b1, t))
        denom = torch._foreach_div(nu, _bias(self.b2, t))
        torch._foreach_add_(denom, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(hat, denom)
        return hat


class _ScaleByRAdam(_Step):
    """optax.scale_by_radam: the rectified update once rho_t reaches
    `threshold`, the bias-corrected momentum before (rho_t is a function of
    the count alone: a host choice, or `torch.where` on a device count)."""

    def __init__(self, b1, b2, eps, eps_root, threshold, nesterov=False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.threshold, self.nesterov = threshold, nesterov
        self.ro_inf = 2.0 / (1.0 - b2) - 1.0

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"), "nu": _Param("nu")}

    def __call__(self, rule, group, params, grads):
        b1, b2, t = self.b1, self.b2, group["count"] + 1
        mu = rule._state(params, "mu", torch.zeros_like)
        nu = rule._state(params, "nu", torch.zeros_like)
        _ema_(mu, grads, b1)
        _ema_sq_(nu, grads, b2)
        # rho_t in f32, as optax computes it (1 - b2^t cancels: f64 would differ)
        ri = self.ro_inf
        b2t = _ipow(b2, t)
        ro = ri - (2 * t) * b2t / (1 - b2t)
        hat = (_nesterov_hat(mu, grads, b1, t) if self.nesterov
               else torch._foreach_div(mu, _bias(b1, t)))
        if not torch.is_tensor(ro) and not ro >= self.threshold:
            return hat
        sqrt = torch.sqrt if torch.is_tensor(ro) else np.sqrt
        with np.errstate(invalid="ignore"):  # NaN below rho 4, as optax's
            r = sqrt((ro - 4.0) * (ro - 2.0) * ri / ((ri - 4.0) * (ri - 2.0) * ro))
        r = r if torch.is_tensor(r) else float(r)
        denom = torch._foreach_div(nu, _bias(b2, t))
        torch._foreach_add_(denom, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        rect = torch._foreach_div(torch._foreach_mul(hat, r), denom)
        return _select(ro >= self.threshold, rect, hat)


class _ScaleByRprop(_Step):
    """optax.scale_by_rprop. As in optax 0.2.6 the update returned is the
    last step's (`state.prev_updates`) where the sign held, so it lags one
    step behind the step sizes. optax's `where`s on the sign of g * g_prev
    are products with its 0/1 indicators here (exact, and `_foreach` over
    every tensor at once)."""

    def __init__(self, learning_rate, eta_minus, eta_plus, min_step_size, max_step_size):
        self.lr, self.eta_minus, self.eta_plus = learning_rate, eta_minus, eta_plus
        self.lo, self.hi = min_step_size, max_step_size

    def layout(self, rule) -> dict:
        return {"step_sizes": _Param("step_sizes"), "prev_updates": _Param("prev_updates")}

    def __call__(self, rule, group, params, grads):
        sizes = rule._state(params, "step_sizes", lambda p: torch.full_like(p, self.lr))
        prev = rule._state(params, "prev_updates", torch.zeros_like)
        sign = torch._foreach_sign(torch._foreach_mul(grads, prev))
        up = torch._foreach_mul(torch._foreach_add(sign, 1.0), sign)  # 2 where s > 0
        down = torch._foreach_mul(torch._foreach_sub(sign, 1.0), sign)  # 2 where s < 0
        torch._foreach_mul_(up, 0.5)
        torch._foreach_mul_(down, 0.5)
        # eta_plus, eta_minus or 1: one term is not 0, so the sum is exact
        grow = torch._foreach_mul(up, self.eta_plus)
        torch._foreach_add_(grow, torch._foreach_mul(down, self.eta_minus))
        torch._foreach_add_(grow, torch._foreach_sub(torch._foreach_neg(torch._foreach_add(up, down)),
                                                     -1.0))
        clipped = torch._foreach_mul(sizes, grow)
        torch._foreach_clamp_min_(clipped, self.lo)
        torch._foreach_clamp_max_(clipped, self.hi)
        # s == 0 keeps the step size unclipped: lerp by |sign| is exact at 0 and 1
        new_sizes = torch._foreach_lerp(sizes, clipped, torch._foreach_abs(sign))
        keep = torch._foreach_neg(down)
        torch._foreach_add_(keep, 1.0)  # 0 where s < 0, else 1
        out = torch._foreach_mul(prev, keep)
        new_prev = torch._foreach_mul(new_sizes, torch._foreach_sign(grads))
        torch._foreach_mul_(new_prev, keep)
        for p, size, last in zip(params, new_sizes, new_prev):
            rule.state[p]["step_sizes"], rule.state[p]["prev_updates"] = size, last
        return out


class _Sign(_Step):
    """optax.scale_by_sign."""

    def __call__(self, rule, group, params, updates):
        return torch._foreach_sign(updates)


class _OptimisticGradient(_Step):
    """optax.scale_by_optimistic_gradient: (alpha + beta) g - beta g_prev,
    g_prev = g on the first step (optax's `is_initial_step`, which is the
    count being 0)."""

    def __init__(self, alpha, beta):
        self.alpha, self.beta = alpha, beta

    def layout(self, rule) -> dict:
        return {"is_initial_step": _Initial(), "previous_gradient": _Param("previous_gradient")}

    def __call__(self, rule, group, params, updates):
        prev = rule._state(params, "previous_gradient", torch.zeros_like)
        prev = _select(group["count"] == 0, updates, prev)
        out = torch._foreach_mul(updates, self.alpha + self.beta)
        torch._foreach_sub_(out, torch._foreach_mul(prev, self.beta))
        for p, u in zip(params, updates):  # no later step writes these
            rule.state[p]["previous_gradient"] = u
        return out


class _TrustRatio(_Step):
    """optax.scale_by_trust_ratio over flax's leaves: u * coeff |p| / (|u|
    + eps), each norm at least `min_norm`, 1 where either norm is 0
    (`torch.where` on the device); `mask` (lars) leaves some leaves as
    they are, in optax's `masked`."""

    def __init__(self, min_norm=0.0, trust_coefficient=1.0, eps=0.0, mask=None):
        self.min_norm, self.coeff, self.eps, self.mask = min_norm, trust_coefficient, eps, mask

    def layout(self, rule) -> dict:
        return {} if self.mask is None else {"inner_state": {}}

    def __call__(self, rule, group, params, updates):
        pn = torch.clamp_min(torch.stack(_leaf_norms(rule, params)), self.min_norm)
        un = torch.clamp_min(torch.stack(_leaf_norms(rule, updates)), self.min_norm)
        ratio = torch.where((pn == 0) | (un == 0), 1.0, self.coeff * pn / (un + self.eps))
        keep = rule._mask_list(self.mask, params)
        per = _per_param(rule, ratio)
        sel = [i for i, k in enumerate(keep) if k]
        if sel:
            torch._foreach_mul_([updates[i] for i in sel], [per[i] for i in sel])
        return updates


class _AddNoise(_Step):
    """optax.add_noise: u + sqrt(eta / t^gamma) N(0, 1). The noise comes
    from a torch.Generator on the parameters' device seeded with `seed`
    (one draw a step over every leaf); a JAX key cannot seed it, so the
    stream is not optax's. Its state rides in the rule's state dict."""

    def __init__(self, eta: float, gamma: float, seed: int):
        self.eta, self.gamma, self.seed = eta, gamma, seed
        self.generator = None

    def layout(self, rule) -> dict:
        return {"count": _Count(), "rng_key": _Unused()}

    def noise(self, rule, updates: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.generator is None:
            self.generator = torch.Generator(device=updates[0].device).manual_seed(self.seed)
            if "rng_state" in rule.state:  # a loaded state dict
                self.generator.set_state(rule.state["rng_state"])
        flat = torch.empty(sum(u.numel() for u in updates), device=updates[0].device,
                           dtype=updates[0].dtype)
        flat.normal_(generator=self.generator)
        rule.state["rng_state"] = self.generator.get_state()
        return [x.view(u.shape) for x, u in zip(flat.split([u.numel() for u in updates]), updates)]

    def __call__(self, rule, group, params, updates):
        t = group["count"] + 1
        if torch.is_tensor(t):
            std = torch.sqrt(self.eta / t.to(torch.float32) ** self.gamma)
        else:
            std = float(np.sqrt(_f32(self.eta) / _f32(t) ** _f32(self.gamma)))
        noise = self.noise(rule, updates)
        torch._foreach_mul_(noise, std)
        torch._foreach_add_(updates, noise)
        return updates


class _ScaleByNovograd(_Step):
    """optax.scale_by_novograd: nu per flax leaf from |g|^2, mu elementwise
    from g / (sqrt(nu + eps_root) + eps) + weight_decay p; the first step
    starts both (a host choice, or `torch.where` on a device count)."""

    def __init__(self, b1, b2, eps, eps_root, weight_decay):
        self.b1, self.b2, self.eps, self.eps_root, self.wd = b1, b2, eps, eps_root, weight_decay

    def layout(self, rule) -> dict:
        return {"count": _Count(), "mu": _Param("mu"),
                "nu": _Leaf(lambda r, leaf, v: _put_leaf(r, leaf, "nu", v))}

    def __call__(self, rule, group, params, grads):
        first = group["count"] == 0
        mu = rule._state(params, "mu", torch.zeros_like)
        heads = [params[idx[0]] for idx in rule._leaves()]
        nu_old = torch.stack(rule._state(heads, "nu", lambda p: torch.zeros((), dtype=p.dtype,
                                                                            device=p.device)))
        sq = torch.stack(_leaf_norms(rule, grads)) ** 2
        nu = sq if first is True else (1 - self.b2) * sq + self.b2 * nu_old
        if torch.is_tensor(first):
            nu = torch.where(first, sq, nu)
        for p, v in zip(heads, nu.unbind()):
            rule.state[p]["nu"] = v
        denom = torch.sqrt(nu + self.eps_root) + self.eps
        add = torch._foreach_div(grads, _per_param(rule, denom))
        if self.wd:
            torch._foreach_add_(add, torch._foreach_mul(params, self.wd))
        torch._foreach_mul_(mu, self.b1)
        new = add if first is True else _select(first, add, torch._foreach_add(mu, add))
        for p, m in zip(params, new):
            rule.state[p]["mu"] = m
        return _copy(new)


def _put_leaf(rule, leaf: int, key: str, value: torch.Tensor) -> None:
    """A per-leaf state value onto the leaf's first parameter."""
    p = rule.param_groups[0]["params"][rule._leaves()[leaf][0]]
    rule.state[p][key] = value.to(p.device)


def _put_slices(rule, leaf: int, key: str, value: torch.Tensor) -> None:
    """An elementwise state of a flax leaf: each parameter its slice."""
    params = rule.param_groups[0]["params"]
    idx = rule._leaves()[leaf]
    for k, i in enumerate(idx):
        rule.state[params[i]][key] = (value if len(idx) == 1 else value[k]).to(params[i].device)


def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    """optax's `_factored_dims`: the two largest axes, when the smaller of
    them has at least `min_dim_size_to_factor`."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class _FactoredRMS(_Step):
    """optax.scale_by_factored_rms (adafactor): per flax leaf, the row and
    column means of g^2 + eps on its two largest axes where those are
    long enough (the leaf as flax stacks it), else the full second moment
    (elementwise, over all such leaves at once). Decay 1 - (t+1)^-0.8 from
    the count less `step_offset`."""

    def __init__(self, factored, decay_rate, step_offset, min_dim_size_to_factor, eps):
        self.factored, self.decay_rate, self.offset = factored, decay_rate, step_offset
        self.min_dim, self.eps = min_dim_size_to_factor, eps

    def dims(self, rule, leaf: int):
        params = rule.param_groups[0]["params"]
        idx = rule._leaves()[leaf]
        shape = tuple(params[idx[0]].shape) if len(idx) == 1 else (len(idx), *params[idx[0]].shape)
        return _factored_dims(shape, self.factored, self.min_dim)

    def layout(self, rule) -> dict:
        def place(field):
            def put(r, leaf, value):
                if (self.dims(r, leaf) is not None) == (field != "v"):
                    (_put_leaf if field != "v" else _put_slices)(r, leaf, field, value)
                elif tuple(value.shape) != (1,):
                    raise ValueError(f"adafactor's {field} of leaf {r.leaf_names()[leaf]}: shape "
                                     f"{tuple(value.shape)}, want the (1,) placeholder")
            return _Leaf(put)

        return {"count": _Count(), "v_row": place("v_row"), "v_col": place("v_col"),
                "v": place("v")}

    def __call__(self, rule, group, params, grads):
        t = group["count"] - self.offset + 1
        if torch.is_tensor(t):
            d = 1.0 - t.to(torch.float32) ** (-self.decay_rate)
        else:
            d = float(_f32(1.0) - _f32(t) ** _f32(-self.decay_rate))
        out = [None] * len(params)
        plain = []
        for leaf, idx in enumerate(rule._leaves()):
            dims = self.dims(rule, leaf)
            if dims is None:
                plain += idx
                continue
            d1, d0 = dims
            g = _stacked(grads, idx)
            head = params[idx[0]]
            shape = tuple(g.shape)
            v_row = rule._state([head], "v_row", lambda p: torch.zeros(
                shape[:d0] + shape[d0 + 1:], dtype=p.dtype, device=p.device))[0]
            v_col = rule._state([head], "v_col", lambda p: torch.zeros(
                shape[:d1] + shape[d1 + 1:], dtype=p.dtype, device=p.device))[0]
            sq = g * g + self.eps
            v_row = d * v_row + (1.0 - d) * sq.mean(dim=d0)
            v_col = d * v_col + (1.0 - d) * sq.mean(dim=d1)
            rule.state[head]["v_row"], rule.state[head]["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            u = g * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            for k, i in enumerate(idx):
                out[i] = u if len(idx) == 1 else u[k]
        if plain:
            ps, gs = [params[i] for i in plain], [grads[i] for i in plain]
            v = rule._state(ps, "v", torch.zeros_like)
            sq = torch._foreach_mul(gs, gs)
            torch._foreach_add_(sq, self.eps)
            torch._foreach_mul_(v, d)
            torch._foreach_mul_(sq, 1.0 - d)
            torch._foreach_add_(v, sq)
            u = torch._foreach_pow(v, -0.5)
            torch._foreach_mul_(u, gs)
            for i, x in zip(plain, u):
                out[i] = x
        return out


class _ClipByBlockRMS(_Step):
    """optax.clip_by_block_rms: each flax leaf divided by max(1, rms /
    threshold) (on the device)."""

    def __init__(self, threshold: float):
        self.threshold = threshold

    def __call__(self, rule, group, params, updates):
        rms = _leaf_rms(rule, updates)
        torch._foreach_mul_(rms, 1 / self.threshold)
        torch._foreach_clamp_min_(rms, 1.0)
        torch._foreach_div_(updates, _per_param(rule, rms))
        return updates


class _ParamBlockRMS(_Step):
    """optax.scale_by_param_block_rms: each flax leaf times max(rms(p),
    min_scale)."""

    def __init__(self, min_scale: float = 1e-3):
        self.min_scale = min_scale

    def __call__(self, rule, group, params, updates):
        rms = _leaf_rms(rule, params)
        torch._foreach_clamp_min_(rms, self.min_scale)
        torch._foreach_mul_(updates, _per_param(rule, rms))
        return updates


class _EMA(_Step):
    """optax.ema (adafactor's momentum: without debiasing), kept in
    `dtype`; with `debias` divided by 1 - decay^t."""

    def __init__(self, decay: float, dtype, debias: bool = False):
        self.decay, self.dtype, self.debias = decay, _dtype(dtype), debias

    def layout(self, rule) -> dict:
        return {"count": _Count(), "ema": _Param("ema")}

    def __call__(self, rule, group, params, updates):
        ema = rule._state(params, "ema", lambda p: torch.zeros_like(p, dtype=self.dtype))
        new = _moment(updates, ema, self.decay)
        for p, m in zip(params, new):
            rule.state[p]["ema"] = m.to(self.dtype or m.dtype, copy=True)  # `new` is scaled in place
        if self.debias:
            return torch._foreach_div(new, _bias(self.decay, group["count"] + 1))
        return new


class _ScaleBySM3(_Step):
    """optax.scale_by_sm3 over flax's leaves: one accumulator per axis of
    each leaf (the leaf as flax stacks it). optax 0.2.6 fails on a 0-d leaf
    (its accumulator list is empty, IndexError); the port raises there
    too."""

    def __init__(self, b1: float = 0.9, b2: float = 1.0, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def layout(self, rule) -> dict:
        def put(r, leaf, value):
            for i in range(len(value)):
                _put_leaf(r, leaf, f"mu_{i}", value[str(i)])

        return {"mu": _Leaf(put), "nu": _Param("nu")}

    def __call__(self, rule, group, params, grads):
        c0, c1 = (1.0 - self.b2) if self.b2 != 1.0 else 1.0, self.b2
        up = [None] * len(params)
        flat = []  # the 1-d leaves: elementwise, their accumulator the leaf itself
        for leaf, idx in enumerate(rule._leaves()):
            g = _stacked(grads, idx)
            if g.ndim == 0:
                raise ValueError(
                    f"sm3 cannot update the 0-d leaf {rule.leaf_names()[leaf]!r}: optax 0.2.6's "
                    "scale_by_sm3 keeps no accumulator for it and fails (IndexError) too")
            head = params[idx[0]]
            mus = [rule._state([head], f"mu_{i}", lambda p, n=n: torch.zeros(
                n, dtype=p.dtype, device=p.device))[0] for i, n in enumerate(g.shape)]
            if g.ndim == 1:
                flat.append((idx[0], g, mus[0]))
                continue
            shapes = [[1] * i + [n] + [1] * (g.ndim - i - 1) for i, n in enumerate(g.shape)]
            low = functools.reduce(torch.minimum, [m.reshape(s) for m, s in zip(mus, shapes)])
            accum = c0 * g**2 + c1 * low
            for i in range(g.ndim):
                rule.state[head][f"mu_{i}"] = accum.amax(dim=[a for a in range(g.ndim) if a != i])
            u = g * torch.where(accum > 0, torch.rsqrt(accum + self.eps), 0.0)
            for k, i in enumerate(idx):
                up[i] = u if len(idx) == 1 else u[k]
        if flat:
            gs, mus = [g for _, g, _ in flat], [m for _, _, m in flat]
            accum = torch._foreach_mul(torch._foreach_mul(gs, gs), c0)
            torch._foreach_add_(accum, torch._foreach_mul(mus, c1))
            # rsqrt(accum + eps) where accum > 0, else 0: accum >= 0, so its sign is the 0/1
            inv = torch._foreach_add(accum, self.eps)
            torch._foreach_rsqrt_(inv)
            torch._foreach_mul_(inv, torch._foreach_sign(accum))
            for (i, g, _), a, v in zip(flat, accum, torch._foreach_mul(inv, gs)):
                rule.state[params[i]]["mu_0"] = a
                up[i] = v
        nu = rule._state(params, "nu", torch.zeros_like)
        _ema_(nu, up, self.b1)
        return _copy(nu)


class _Chain(_OptaxRule):
    """A rule of optax's as its chain of steps (`make_steps()`, built per
    optimizer so that a step's generator is its own); with `bare`, one
    transform alone, whose state is its step's (not a chain's)."""

    def __init__(self, params, make_steps: Callable, lr=None, alias: str = "chain",
                 schedule: Optional[Callable[[int], float]] = None, bare: bool = False):
        super().__init__(params, dict(lr=lr), schedule)
        self.alias, self.bare = alias, bare
        self.steps = make_steps()

    def _layout(self) -> dict:
        if self.bare:
            return self.steps[0].layout(self)
        return _chain([s.layout(self) for s in self.steps])

    def _update(self, group, params, updates):
        updates = _copy(updates)
        for s in self.steps:
            updates = s(self, group, params, updates)
        return updates


# ---- updates the device decides on: apply_if_finite, MultiSteps' skips ----


def _tracked(node: _Node, run: Callable):
    """run(), an update of `node`, with what it changes: (its output, the
    group entries and state entries of `node` (and the nodes inside it)
    before it, each state entry it made with the value it was made with)."""
    global _FRESH
    group = node._root.param_groups[0]
    before = {key: (v.clone() if torch.is_tensor(v) else v) for key, v in group.items()
              if key != "params" and _owned(node, key)}
    entries = _state_entries(node)
    saved = dict(zip([(id(d), k) for d, k in entries],
                     _copy([d[k] for d, k in entries]) if entries else []))
    outer, _FRESH = _FRESH, {}
    try:
        out = run()
        fresh = _FRESH
    finally:
        _FRESH = outer
    if outer is not None:  # made inside an inner guard: made for the outer one too
        outer.update(fresh)
    return out, before, saved, fresh


def _guarded(node: _Node, cond, run: Callable):
    """run(), an update of `node`, whose effect on `node`'s state and counts
    (those of the nodes inside it too) stands where the device bool `cond`
    holds; elsewhere each keeps its value, and an entry the update made the
    value it was made with. Both are `torch.where`s on the device: nothing
    is read on the host. A host bool runs the update or not."""
    if not torch.is_tensor(cond):
        return run() if cond else None
    node._prepare(cond.device)
    out, before, saved, fresh = _tracked(node, run)
    group = node._root.param_groups[0]
    for key, v in _group_entries(node):
        old = before.get(key)
        if torch.is_tensor(v) and old is not None:
            group[key] = torch.where(cond, v, old if torch.is_tensor(old)
                                     else torch.full_like(v, old))
    for d, k in _state_entries(node):
        old = saved.get((id(d), k), fresh.get((id(d), k)))
        if old is not None:
            d[k] = torch.where(cond, d[k], old)
    return out


def _discarded(node: _Node, run: Callable):
    """run(), an update of `node`, with its state and counts put back as
    they were (an entry it made: the value it was made with) and its output
    returned (MultiSteps' micro-steps that do not emit)."""
    out, before, saved, fresh = _tracked(node, run)
    group = node._root.param_groups[0]
    for key in [k for k in group if k != "params" and _owned(node, k)]:
        if key in before:
            group[key] = before[key]
        else:
            del group[key]
    for d, k in _state_entries(node):
        old = saved.get((id(d), k), fresh.get((id(d), k)))
        if old is None:
            del d[k]
        else:
            d[k] = old
    return out


def _owned(node: _Node, key: str) -> bool:
    return key.startswith(node._prefix) and key[len(node._prefix):] not in node._reserved


def _group_entries(node: _Node) -> list:
    """(key, value) of the numbers and tensors `node` keeps in the group."""
    return [(k, v) for k, v in node._root.param_groups[0].items()
            if k != "params" and _owned(node, k)
            and (torch.is_tensor(v) or (isinstance(v, (int, float)) and not isinstance(v, bool)))]


def _state_entries(node: _Node) -> list:
    """(dict, key) of the tensors `node` keeps in its parameters' state."""
    out, seen = [], set()
    for p in node._params:
        real = node._root._alias.get(id(p), p)
        if id(real) in seen:
            continue
        seen.add(id(real))
        d = node._root.state[real]
        out += [(d, k) for k, v in d.items() if torch.is_tensor(v) and _owned(node, k)]
    return out


# ---- optax's wrappers: MultiSteps, apply_if_finite ----


class _Combinator(_Node):
    """A node around other nodes (`_kids()`). It chains `schedule`
    (`model.lr_scheduler`) at its own count, `schedule_count`, which
    advances every step as optax's chained `scale_by_schedule` does."""

    def __init__(self, params, defaults: dict, schedule: Optional[Callable[[int], float]]):
        names, tensors = _named(params)
        super().__init__(tensors, dict(defaults, schedule_count=0))
        self._init_node(tensors, names)
        self.schedule = schedule

    def _pairs(self, keep: Optional[List[bool]] = None) -> list:
        """This node's (name, parameter) pairs (bare tensors without names),
        those that `keep` marks."""
        items = (list(zip(self.names, self._params)) if self.names is not None
                 else list(self._params))
        return items if keep is None else [x for x, k in zip(items, keep) if k]

    def _advance(self, group) -> None:
        group["schedule_count"] += 1

    def _schedule_count(self, group):
        return group["schedule_count"]

    def _schedule_slot(self) -> _Slot:
        return _Group("schedule_count")


class _Wrapper(_Combinator):
    """An optax wrapper around one rule, wrapper or combinator of this
    module. A rule inside shares the wrapper's storage (the wrapper's own
    keys, `_OWN`, beside the rule's, so that a state dict holds both); any
    other node sits under "inner/"."""

    def __init__(self, params, inner: Callable, defaults: dict,
                 schedule: Optional[Callable[[int], float]]):
        super().__init__(params, defaults, schedule)
        rule = inner(self._pairs())
        if not isinstance(rule, _Node):
            raise NotImplementedError(
                f"{type(self).__name__[1:]} around {type(rule).__name__}: the port wraps optax's "
                f"rules of this module ({_OTHER})")
        if isinstance(rule, _OptaxRule):
            _attach(rule, self, "", reserved=self._OWN)
        else:
            _attach(rule, self, "inner/")
        self.inner = rule

    def _kids(self) -> list:
        return [self.inner]


class _MultiSteps(_Wrapper):
    """optax.MultiSteps: the gradients of `every_k_schedule(gradient_step)`
    micro-steps accumulate (their mean with `use_grad_mean`, else their
    sum), and the rule's update on them counts at the last one. As optax,
    the rule runs on every micro-step: its state stands where the micro-step
    emits (`_guarded`), and the update it gives is multiplied by whether it
    does (so a non-finite one reaches the parameters as optax's does). With
    `should_skip_update_fn` (optax's `skip_not_finite` or
    `skip_large_updates`) a skipped micro-step gives zeros and leaves
    `mini_step`, `gradient_step`, the accumulated gradients and the rule's
    state as they were: a skip is device data, so the counts are device
    tensors and `torch.where` decides (`_guarded`); nothing is read on the
    host. Without one the counts are Python ints (`_update_on_host`)."""

    _OWN = ("mini_step", "gradient_step", "schedule_count", "acc_grads")

    def __init__(self, params, opt: Callable, every_k_schedule, use_grad_mean: bool = True,
                 should_skip_update_fn=None, schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, opt, dict(mini_step=0, gradient_step=0), schedule)
        self.every_k = every_k_schedule if callable(every_k_schedule) else (
            lambda step: every_k_schedule)
        self.use_grad_mean = use_grad_mean
        self.should_skip = should_skip_update_fn

    def _layout(self) -> dict:
        return {"mini_step": _Group("mini_step"), "gradient_step": _Group("gradient_step"),
                "inner_opt_state": _Scope(self.inner), "acc_grads": _Param("acc_grads"),
                "skip_state": {} if self.should_skip is None else _Unused()}

    def _update(self, group, params, grads):
        acc = self._state(params, "acc_grads", torch.zeros_like)
        if self.should_skip is None and not torch.is_tensor(group["mini_step"]):
            return self._update_on_host(group, grads, acc)
        self._prepare(params[0].device)
        m, gs = group["mini_step"], group["gradient_step"]
        k = self.every_k(gs)
        if self.should_skip is None:
            skip = torch.zeros((), dtype=torch.bool, device=m.device)
        else:
            skip, _ = self.should_skip(grads, gs, params)
        if self.use_grad_mean:  # Welford's mean, as optax
            new = torch._foreach_sub(grads, acc)
            torch._foreach_div_(new, (m + 1).to(torch.float32))
            torch._foreach_add_(new, acc)
        else:
            new = torch._foreach_add(grads, acc)
        emit = m == k - 1
        out = _guarded(self.inner, emit & ~skip, lambda: self.inner.update(_copy(new)))
        kept = torch._foreach_mul(new, (~emit).to(grads[0].dtype))
        for p, a, n in zip(params, acc, kept):
            self.state[p]["acc_grads"] = torch.where(skip, a, n)
        group["mini_step"] = torch.where(skip, m, (m + 1) % k)
        group["gradient_step"] = torch.where(skip, gs, gs + emit.to(gs.dtype))
        return [torch.where(skip, 0.0, u) for u in torch._foreach_mul(out, emit.to(out[0].dtype))]

    def _update_on_host(self, group, grads, acc):
        """Without a skip function, and with host counts: whether the
        micro-step emits is known on the host, so a micro-step that does not
        emit puts the rule's state back by reassignment (`_discarded`) rather
        than a `torch.where` of each state tensor."""
        m = group["mini_step"]
        if self.use_grad_mean:  # Welford's mean, as optax
            d = torch._foreach_sub(grads, acc)
            torch._foreach_div_(d, m + 1)
            torch._foreach_add_(acc, d)
        else:
            torch._foreach_add_(acc, grads)
        k = int(self.every_k(group["gradient_step"]))
        emit = m == k - 1
        if emit:
            out = self.inner.update(_copy(acc))
            torch._foreach_mul_(acc, 0.0)  # optax's (1 - emit) acc: a NaN stays
            group["gradient_step"] += 1
        else:
            out = _discarded(self.inner, lambda: self.inner.update(_copy(acc)))
            torch._foreach_mul_(out, 0.0)  # optax's emit u: a non-finite update stays
        group["mini_step"] = (m + 1) % k
        return out


_ON_DEVICE = (("notfinite_count", torch.int32), ("total_notfinite", torch.int32),
              ("last_finite", torch.bool))


class _ApplyIfFinite(_Wrapper):
    """optax.apply_if_finite: a step whose gradients are not all finite
    gives a zero update and leaves the rule's state and counts as they
    were, until more than `max_consecutive_errors` such steps come in a
    row. The choice is device data, so the rule steps every time and
    `torch.where` keeps the old values where the step does not count
    (`_guarded`): the counts are device tensors and nothing is read on the
    host."""

    _OWN = ("notfinite_count", "last_finite", "total_notfinite", "max_consecutive_errors",
            "schedule_count")

    def __init__(self, params, inner: Callable, max_consecutive_errors: int,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, inner, dict(notfinite_count=0, last_finite=True,
                                             total_notfinite=0,
                                             max_consecutive_errors=max_consecutive_errors),
                         schedule)

    def _layout(self) -> dict:
        return {"notfinite_count": _Group("notfinite_count", device=True),
                "last_finite": _Group("last_finite", device=True),
                "total_notfinite": _Group("total_notfinite", device=True),
                "inner_state": _Scope(self.inner)}

    def _update(self, group, params, grads):
        dev = params[0].device
        for key, dtype in _ON_DEVICE:
            v = group[key]
            if not torch.is_tensor(v):  # a fill on the device: no copy from the host
                group[key] = torch.full((), v, dtype=dtype, device=dev)
            elif v.device != dev:  # a state dict loaded onto the CPU
                group[key] = v.to(dev)
        finite = torch.stack(torch._foreach_norm(grads, ord=math.inf)).isfinite().all()
        notfinite = torch.where(finite, 0, group["notfinite_count"] + 1)
        ok = finite | (notfinite > group["max_consecutive_errors"])
        out = _guarded(self.inner, ok, lambda: self.inner.update(grads))
        group["total_notfinite"] = torch.where(finite, group["total_notfinite"],
                                               group["total_notfinite"] + 1)
        group["notfinite_count"], group["last_finite"] = notfinite, finite
        return [torch.where(ok, u, 0.0) for u in out]


def MultiSteps(opt, every_k_schedule, use_grad_mean: bool = True, should_skip_update_fn=None):
    """optax.MultiSteps(opt, every_k_schedule, use_grad_mean,
    should_skip_update_fn) -> `params -> _MultiSteps` around `opt` (a
    factory of this module, as a config's nested `_target_` builds it)."""
    return functools.partial(_MultiSteps, opt=opt, every_k_schedule=every_k_schedule,
                             use_grad_mean=use_grad_mean,
                             should_skip_update_fn=should_skip_update_fn)


def apply_if_finite(inner, max_consecutive_errors: int):
    """optax.apply_if_finite(inner, max_consecutive_errors) -> `params ->
    _ApplyIfFinite` around `inner`."""
    return functools.partial(_ApplyIfFinite, inner=inner,
                             max_consecutive_errors=max_consecutive_errors)


def skip_not_finite(updates: List[torch.Tensor], gradient_step, params):
    """optax.skip_not_finite: skip where any update is not finite (a device
    bool; the largest magnitude of each tensor is then not finite). optax's
    count of such entries, which only its skip state keeps, is not made."""
    skip = ~torch.stack(torch._foreach_norm(updates, ord=math.inf)).isfinite().all()
    return skip, {"should_skip": skip}


def skip_large_updates(updates: List[torch.Tensor], gradient_step, params,
                       max_squared_norm: float):
    """optax.skip_large_updates: skip where the squared norm of the updates
    is not below `max_squared_norm` (a NaN norm too)."""
    norm_sq = _sq_norm(updates)
    skip = ~(norm_sq < max_squared_norm)
    return skip, {"should_skip": skip, "norm_squared": norm_sq}


def bind(optimizer: Callable, module: torch.nn.Module) -> torch.optim.Optimizer:
    """A factory bound to `module`'s parameters: a rule of this module gets
    them with their flax names (a `mask` reads them; a scanned E3Conv's
    layer slices share their stacked leaf's name, `params.flax_names`), any
    other factory (a torch optimizer) the tensors alone."""
    from jamun_tpu_torch.params import flax_names

    named = list(module.named_parameters())
    func = optimizer.func if isinstance(optimizer, functools.partial) else optimizer
    if isinstance(func, type) and issubclass(func, _Node):
        names = flax_names([n for n, _ in named], getattr(module, "scan_layers", False))
        return optimizer(list(zip(names, [p for _, p in named])))
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


# ---- the rest of optax's rules: chains of the steps above ----


def _rule(alias: str, learning_rate, make_steps: Callable):
    return functools.partial(_Chain, make_steps=make_steps, lr=learning_rate, alias=alias)


def adabelief(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
              eps_root: float = 1e-16, *, nesterov: bool = False):
    """optax.adabelief."""
    return _rule("adabelief", learning_rate, lambda: [
        _ScaleByBelief(b1, b2, eps, eps_root, nesterov), _ScaleByLR(learning_rate)])


def adadelta(learning_rate=None, rho: float = 0.9, eps: float = 1e-6, weight_decay: float = 0.0,
             weight_decay_mask=None):
    """optax.adadelta (no learning rate: optax's identity, the update
    unscaled and unflipped)."""
    return _rule("adadelta", learning_rate, lambda: [
        _AddDecayedWeights(weight_decay, weight_decay_mask), _ScaleByAdadelta(rho, eps),
        _ScaleByLR(learning_rate)])


def adafactor(learning_rate=None, min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0, multiply_by_parameter_scale: float = True,
              clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
              dtype_momentum="float32", weight_decay_rate: Optional[float] = None,
              eps: float = 1e-30, factored: bool = True, weight_decay_mask=None):
    """optax.adafactor."""
    def steps():
        out = [_FactoredRMS(factored, decay_rate, decay_offset, min_dim_size_to_factor, eps)]
        if clipping_threshold is not None:
            out.append(_ClipByBlockRMS(clipping_threshold))
        if learning_rate is not None:
            out.append(_ScaleByLR(learning_rate, flip_sign=False))
        if multiply_by_parameter_scale:
            out.append(_ParamBlockRMS())
        if momentum is not None:
            out.append(_EMA(momentum, dtype_momentum))
        if weight_decay_rate is not None:
            out.append(_AddDecayedWeights(weight_decay_rate, weight_decay_mask))
        return out + [_Scale(-1)]

    return _rule("adafactor", learning_rate, steps)


def adamaxw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
            weight_decay: float = 1e-4, mask=None):
    """optax.adamaxw."""
    return _rule("adamaxw", learning_rate, lambda: [
        _ScaleByAdamax(b1, b2, eps), _AddDecayedWeights(weight_decay, mask),
        _ScaleByLR(learning_rate)])


def adan(learning_rate, b1: float = 0.98, b2: float = 0.92, b3: float = 0.99, eps: float = 1e-8,
         eps_root: float = 1e-8, weight_decay: float = 0.0, mask=None):
    """optax.adan."""
    return _rule("adan", learning_rate, lambda: [
        _ScaleByAdan(b1, b2, b3, eps, eps_root), _AddDecayedWeights(weight_decay, mask),
        _ScaleByLR(learning_rate)])


def amsgrad(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
            eps_root: float = 0.0, mu_dtype=None):
    """optax.amsgrad."""
    return _rule("amsgrad", learning_rate, lambda: [
        _ScaleByAmsgrad(b1, b2, eps, eps_root, mu_dtype), _ScaleByLR(learning_rate)])


def fromage(learning_rate, min_norm: float = 1e-6):
    """optax.fromage: the trust ratio, lr / sqrt(1 + lr^2), and a decay of
    1 / sqrt(1 + lr^2) - 1 (in f32 as optax; with a schedule, the decay is
    read at count 0, as optax 0.2.6 reads it)."""
    if callable(learning_rate):
        def mult(count):
            lr = learning_rate(count)
            return 1 / torch.sqrt(1 + lr**2) if torch.is_tensor(lr) else (
                _f32(1) / np.sqrt(_f32(1) + _f32(lr) ** 2))

        scale = lambda c: mult(c) * learning_rate(c)  # noqa: E731
        decay = lambda c: mult(c) - 1  # noqa: E731
    else:
        m = _f32(1) / np.sqrt(_f32(1 + learning_rate**2))
        scale, decay = float(_f32(learning_rate) * m), float(m - _f32(1))
    return _rule("fromage", learning_rate, lambda: [
        _TrustRatio(min_norm), _ScaleByLR(scale), _AddDecayedWeights(decay)])


def lamb(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         eps_root: float = 0.0, weight_decay: float = 0.0, mask=None):
    """optax.lamb."""
    return _rule("lamb", learning_rate, lambda: [
        _ScaleByAdam(b1, b2, eps, eps_root), _AddDecayedWeights(weight_decay, mask),
        _TrustRatio(), _ScaleByLR(learning_rate)])


def lars(learning_rate, weight_decay: float = 0.0, weight_decay_mask=True,
         trust_coefficient: float = 0.001, eps: float = 0.0, trust_ratio_mask=True,
         momentum: float = 0.9, nesterov: bool = False):
    """optax.lars."""
    return _rule("lars", learning_rate, lambda: [
        _AddDecayedWeights(weight_decay, weight_decay_mask),
        _TrustRatio(trust_coefficient=trust_coefficient, eps=eps, mask=trust_ratio_mask),
        _ScaleByLR(learning_rate), _Trace(momentum, nesterov)])


def noisy_sgd(learning_rate, eta: float = 0.01, gamma: float = 0.55, key=None, *,
              seed: Optional[int] = None):
    """optax.noisy_sgd; `key` (an int here) or `seed` seeds the port's
    torch generator (0 by default, as optax's key)."""
    if key is not None and seed is not None:
        raise ValueError("Only one of seed or key can be specified.")
    seed = int(key if key is not None else seed or 0)
    return _rule("noisy_sgd", learning_rate, lambda: [
        _AddNoise(eta, gamma, seed), _ScaleByLR(learning_rate)])


def novograd(learning_rate, b1: float = 0.9, b2: float = 0.25, eps: float = 1e-6,
             eps_root: float = 0.0, weight_decay: float = 0.0):
    """optax.novograd."""
    return _rule("novograd", learning_rate, lambda: [
        _ScaleByNovograd(b1, b2, eps, eps_root, weight_decay), _ScaleByLR(learning_rate)])


def optimistic_gradient_descent(learning_rate, alpha: float = 1.0, beta: float = 1.0):
    """optax.optimistic_gradient_descent."""
    return _rule("optimistic_gradient_descent", learning_rate, lambda: [
        _OptimisticGradient(alpha, beta), _ScaleByLR(learning_rate)])


def optimistic_adam(learning_rate: float, optimism: Optional[float] = None, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-08, eps_root: float = 0.0, mu_dtype=None,
                    *, nesterov: bool = True):
    """optax.optimistic_adam (deprecated there for v2): alpha the learning
    rate, beta the optimism, and a learning rate of 1."""
    if callable(learning_rate):
        raise ValueError("This version of `optimistic_adam` does not support learning rate "
                         "schedules but `optimistic_adam_v2` does.")
    beta = learning_rate if optimism is None else optimism
    return _rule("optimistic_adam", 1.0, lambda: [
        _ScaleByAdam(b1, b2, eps, eps_root, mu_dtype, nesterov),
        _OptimisticGradient(learning_rate, beta), _ScaleByLR(1.0)])


def optimistic_adam_v2(learning_rate, *, alpha: float = 1.0, beta: float = 1.0, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-08, eps_root: float = 0.0,
                       mu_dtype=None, nesterov: bool = True):
    """optax.optimistic_adam_v2."""
    return _rule("optimistic_adam_v2", learning_rate, lambda: [
        _ScaleByAdam(b1, b2, eps, eps_root, mu_dtype, nesterov),
        _OptimisticGradient(alpha, beta), _ScaleByLR(learning_rate)])


def radam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, threshold: float = 5.0, *, nesterov: bool = False):
    """optax.radam."""
    return _rule("radam", learning_rate, lambda: [
        _ScaleByRAdam(b1, b2, eps, eps_root, threshold, nesterov), _ScaleByLR(learning_rate)])


def rprop(learning_rate: float, eta_minus: float = 0.5, eta_plus: float = 1.2,
          min_step_size: float = 1e-6, max_step_size: float = 50.0):
    """optax.rprop (its learning rate is the first step size)."""
    return _rule("rprop", learning_rate, lambda: [
        _ScaleByRprop(learning_rate, eta_minus, eta_plus, min_step_size, max_step_size),
        _Scale(-1.0)])


def sign_sgd(learning_rate):
    """optax.sign_sgd."""
    return _rule("sign_sgd", learning_rate, lambda: [_Sign(), _ScaleByLR(learning_rate)])


def sm3(learning_rate: float, momentum: float = 0.9):
    """optax.sm3 (`scale(-learning_rate)`: a float, as optax needs)."""
    return _rule("sm3", learning_rate, lambda: [_ScaleBySM3(momentum), _Scale(-learning_rate)])


def yogi(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3):
    """optax.yogi."""
    return _rule("yogi", learning_rate, lambda: [_ScaleByYogi(b1, b2, eps),
                                                 _ScaleByLR(learning_rate)])


# ---- optax's schedules: step -> value, in f32 as JAX computes them ----
#
# A count is a Python int (numpy's f32 scalars compute the value on the
# host) or, inside `apply_if_finite`, a device tensor (torch computes it
# there, with no host read); `_Num` holds the few operations that differ.

_f32 = np.float32


class _Num:
    def __init__(self, count):
        self.device = torch.is_tensor(count)

    def f32(self, x):
        """x in f32; beside a device count a constant stays a Python float
        (a numpy scalar would read the tensor on the host)."""
        if torch.is_tensor(x):
            return x.to(torch.float32)
        return float(x) if self.device else _f32(x)

    def clip(self, x, lo, hi):
        return x.clamp(lo, hi) if torch.is_tensor(x) else np.clip(x, lo, hi)

    def minimum(self, x, v):
        return torch.clamp_max(x, v) if torch.is_tensor(x) else np.minimum(x, _f32(v))

    def maximum(self, x, v):
        return torch.clamp_min(x, v) if torch.is_tensor(x) else np.maximum(x, _f32(v))

    def cos(self, x):
        return torch.cos(x) if torch.is_tensor(x) else np.cos(x)

    def floor(self, x):
        return torch.floor(x) if torch.is_tensor(x) else np.floor(x)

    def sqrt(self, x):
        return torch.sqrt(x) if torch.is_tensor(x) else np.sqrt(x)

    def where(self, cond, a, b):
        if torch.is_tensor(cond):
            return torch.where(cond, a, b)
        return a if cond else b


def constant_schedule(value):
    """optax.constant_schedule."""
    return lambda count: value


def polynomial_schedule(init_value, end_value, power, transition_steps: int,
                        transition_begin: int = 0):
    """optax.polynomial_schedule."""
    if transition_steps <= 0:
        return lambda count: init_value
    begin = max(transition_begin, 0)

    def schedule(count):
        n = _Num(count)
        c = n.f32(n.clip(count - begin, 0, transition_steps))
        frac = n.f32(1) - c / n.f32(transition_steps)
        return _value(n.f32(init_value - end_value) * frac ** n.f32(power) + n.f32(end_value))

    return schedule


def linear_schedule(init_value, end_value, transition_steps: int, transition_begin: int = 0):
    """optax.linear_schedule (polynomial of power 1)."""
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0):
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count):
        n = _Num(count)
        c = n.f32(n.minimum(count, decay_steps)) if n.device else _f32(min(count, decay_steps))
        cosine = n.f32(0.5) * (n.f32(1) + n.cos(n.f32(math.pi) * c / n.f32(decay_steps)))
        decayed = n.f32(1 - alpha) * cosine ** n.f32(exponent) + n.f32(alpha)
        return _value(n.f32(init_value) * decayed)

    return schedule


def join_schedules(schedules, boundaries):
    """optax.join_schedules: schedules[i + 1] from boundaries[i] on, read
    at the count less that boundary."""
    schedules, boundaries = list(schedules), list(boundaries)

    def schedule(count):
        n = _Num(count)
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = n.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0, exponent: float = 1.0):
    """optax.warmup_cosine_decay_schedule: linear warm-up to `peak_value`,
    then cosine decay to `end_value` at `decay_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules([
        linear_schedule(init_value, peak_value, warmup_steps),
        cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent),
    ], [warmup_steps])


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      transition_begin: int = 0, staircase: bool = False,
                      end_value: Optional[float] = None):
    """optax.exponential_decay."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    begin = max(transition_begin, 0)

    def schedule(count):
        n = _Num(count)
        dc = count - begin
        p = n.f32(dc) / n.f32(transition_steps)
        if staircase:
            p = n.floor(p)
        value = n.where(dc <= 0, n.f32(init_value),
                        n.f32(init_value) * n.f32(decay_rate) ** p if n.device
                        else _f32(init_value) * np.power(_f32(decay_rate), p))
        if end_value is not None:
            value = (n.maximum if decay_rate < 1.0 else n.minimum)(value, end_value)
        return _value(value)

    return schedule


def piecewise_constant_schedule(init_value: float, boundaries_and_scales=None):
    """optax.piecewise_constant_schedule: the value times each scale whose
    boundary the count has reached (YAML's integer keys, or strings of
    them)."""
    items = sorted((int(k), float(v)) for k, v in (boundaries_and_scales or {}).items())
    if any(scale < 0.0 for _, scale in items):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")

    def schedule(count):
        n = _Num(count)
        v = n.f32(init_value)
        for threshold, scale in items:
            # optax: indicator = max(0, sign(threshold - count))
            indicator = n.f32(n.where(count < threshold, 1, 0))
            v = v * indicator + (n.f32(1) - indicator) * n.f32(scale) * v
        return _value(v)

    return schedule


def piecewise_interpolate_schedule(interpolate_type: str, init_value: float,
                                   boundaries_and_scales=None):
    """optax.piecewise_interpolate_schedule ('linear' or 'cosine')."""
    if interpolate_type not in ("linear", "cosine"):
        raise ValueError("`interpolate_type` must be either 'cosine' or 'linear'")
    items = sorted((int(k), float(v)) for k, v in (boundaries_and_scales or {}).items())
    if any(scale < 0.0 for _, scale in items):
        raise ValueError("`piecewise_interpolate_schedule` expects non-negative scale factors")
    bounds = [0] + [b for b, _ in items]
    values = np.cumprod(np.array([init_value] + [v for _, v in items], np.float64)).astype(np.float32)
    sizes = [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]

    def schedule(count):
        n = _Num(count)
        out = n.f32(0)
        for lo, hi, size, a, b in zip(bounds[:-1], bounds[1:], sizes, values[:-1], values[1:]):
            inside = n.f32(n.where((lo <= count) & (count < hi), 1, 0))
            with np.errstate(divide="ignore", invalid="ignore"):
                pct = n.f32(count - lo) / n.f32(size)
            if interpolate_type == "linear":
                interp = (n.f32(b) - n.f32(a)) * pct + n.f32(a)
            else:
                interp = n.f32(b) + (n.f32(a) - n.f32(b)) / n.f32(2) * (n.cos(n.f32(math.pi) * pct) + n.f32(1))
            out = out + inside * interp
        last = n.f32(n.where(bounds[-1] <= count, 1, 0))
        return _value(out + last * n.f32(values[-1]))

    return schedule


def linear_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             pct_final: float = 0.85, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """optax.linear_onecycle_schedule."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    return piecewise_interpolate_schedule("linear", peak_value / div_factor, {
        int(pct_start * transition_steps): div_factor,
        int(pct_final * transition_steps): 1.0 / div_factor,
        transition_steps: 1.0 / final_div_factor,
    })


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    return piecewise_interpolate_schedule("cosine", peak_value / div_factor, {
        int(pct_start * transition_steps): div_factor,
        int(transition_steps): 1.0 / (div_factor * final_div_factor),
    })


def warmup_constant_schedule(init_value: float, peak_value: float, warmup_steps: int):
    """optax.warmup_constant_schedule."""
    return linear_schedule(init_value, peak_value, warmup_steps)


def warmup_exponential_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                      transition_steps: int, decay_rate: float,
                                      transition_begin: int = 0, staircase: bool = False,
                                      end_value: Optional[float] = None):
    """optax.warmup_exponential_decay_schedule."""
    return join_schedules([
        linear_schedule(init_value, peak_value, warmup_steps),
        exponential_decay(peak_value, transition_steps, decay_rate, transition_begin, staircase,
                          end_value),
    ], [warmup_steps])


def sgdr_schedule(cosine_kwargs):
    """optax.sgdr_schedule: warm restarts, one warmup_cosine_decay_schedule
    per dict of `cosine_kwargs`."""
    boundaries, schedules, step = [], [], 0
    for kwargs in cosine_kwargs:
        schedules.append(warmup_cosine_decay_schedule(**kwargs))
        boundaries.append(step + kwargs["decay_steps"])
        step += kwargs["decay_steps"]
    return join_schedules(schedules, boundaries[:-1])
