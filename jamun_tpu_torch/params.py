"""Parameter bridge between a flax param tree of a JAX arch (E3Conv,
Ophiuchus) and the port's `state_dict()` of the same arch.

The torch modules carry the flax names, so the mapping is the tree path
joined with "." (e.g. `_HiddenLayer_0/ConvBlock_0/Conv_0/radial_nn/Dense_1/
kernel` -> `_HiddenLayer_0.ConvBlock_0.Conv_0.radial_nn.Dense_1.kernel`).
Orientation is kept as flax has it: a Dense `kernel` is [in, out] and the
port's `ops.mlp.Dense` computes x @ kernel + bias; IrrepsLinear kernels
`w_i_j` are [mul_in, mul_out] on both sides. Nothing is transposed.

The same holds for every module of the equivariant-ops library:
`ExperimentalConv` / `Conv(tensor_product="experimental")` (its radial MLP
alone, `radial_nn/Dense_k/{kernel, bias}`: the external linear's weights
come from it, and there is no post-linear), `IrrepsLinear` with paths of
any l (`w_{i_in}_{i_out}` [mul_in, mul_out]),
`MultiheadAttention` (`IrrepsLinear_0` the queries, `_PerEdgeConv_0/1` the
keys and values, each a `radial_nn`, `dot_w` [weight_numel], `IrrepsLinear_1`),
`TransformerBlock` (`IrrepsLinear_0`-`_3`, `MultiheadAttention_0`,
`EquivariantMLP_0`), the wrappers of `ops/wrappers.py`, and EquiFold's
modules (`ops/contrib/equifold.py`): `SVLinear`'s `w_s` [out, in], `b_s`
[out], `w_v` [out, in]; per head (`DTPByHead`, Equiformer's `w_s_init`,
`attn_msg_w_s`, ...) [H, out, in] and [H, out]; `RadialNN`'s `Dense_k` as
flax's Dense ([in, out]). None of these is transposed either.

`load_jax_train_state` places a whole JAX train state (as
`train.checkpoints.read_flax_msgpack` reads it) in the port's `TrainState`;
`init_parameters` draws a module's parameters from a seed (each submodule's
flax initializer, on a CPU generator).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params", "load_jax_train_state", "init_parameters"]

_OTHER = "ROADMAP.md queue A, 'Other config targets'"


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (optionally under "params") -> a
    state_dict of f32 tensors for the arch's `load_state_dict(..., strict=True)`."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, name)
            else:
                out[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: a state_dict -> {"params": nested dict of numpy arrays}."""
    tree: dict = {}
    for name, t in state_dict.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().cpu().numpy()
    return {"params": tree}


def init_parameters(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every submodule's `reset_parameters(generator)` (flax's init
    distributions) from one CPU generator seeded with `seed`, in module
    order; returns the module."""
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
    return module


def _chain(node, what: str) -> List:
    """A tuple of optax states as flax stores it (a map keyed "0", "1", ...)
    -> its entries."""
    if not isinstance(node, Mapping) or sorted(node) != sorted(str(i) for i in range(len(node))):
        raise ValueError(f"{what}: want a chain of optax states, got keys {sorted(node)!r}")
    return [node[str(i)] for i in range(len(node))]


def _by_name(tree: Mapping, names: List[str], what: str) -> Dict[str, torch.Tensor]:
    leaves = from_jax_params(tree)
    if sorted(leaves) != sorted(names):
        raise ValueError(f"{what}: leaves {sorted(set(leaves) ^ set(names))} differ from the parameters")
    return leaves


def _load_jax_opt_state(opt_state: Mapping, module: torch.nn.Module, optimizer, step: int) -> None:
    """optax's state for the rules of `train/optim.py`, each leaf placed by
    its parameter's name: adam {"0": {count, mu, nu}, "1": {}}, adamw the
    same with a third empty entry, adagrad {"0": {sum_of_squares}, "1": {}},
    and with `model.lr_scheduler` the chain {"0": <rule>, "1": {count}}
    (`cmdline/common.build_optimizer`)."""
    from jamun_tpu_torch.train.optim import Adagrad, Adam  # train/ imports this module

    if not isinstance(optimizer, (Adam, Adagrad)):
        raise NotImplementedError(
            f"JAX's optimizer state into {type(optimizer).__name__} is not ported ({_OTHER})"
        )
    named = list(module.named_parameters())
    names = [n for n, _ in named]
    if len(optimizer.param_groups) != 1 or [id(p) for p in optimizer.param_groups[0]["params"]] != [
        id(p) for _, p in named
    ]:
        raise ValueError("the optimizer must hold the module's parameters in one group")
    group = optimizer.param_groups[0]
    entries = _chain(opt_state, "opt_state")
    schedule_count = None
    if optimizer.schedule is not None:
        if len(entries) != 2 or not isinstance(entries[1], Mapping) or set(entries[1]) != {"count"}:
            raise NotImplementedError(
                f"opt_state has no chained scale_by_schedule entry the port can place ({_OTHER})"
            )
        schedule_count = int(np.asarray(entries[1]["count"]))
        entries = _chain(entries[0], "opt_state/0")
    if any(e != {} for e in entries[1:]):
        raise ValueError(f"opt_state: the entries after the rule's must be empty, got {entries[1:]!r}")

    if isinstance(optimizer, Adam):
        want = 3 if group["weight_decay"] else 2  # adamw chains add_decayed_weights
        if len(entries) != want or set(entries[0]) != {"count", "mu", "nu"}:
            raise ValueError(f"opt_state does not hold {'adamw' if want == 3 else 'adam'}'s state")
        count = int(np.asarray(entries[0]["count"]))
        mu = _by_name(entries[0]["mu"], names, "opt_state mu")
        nu = _by_name(entries[0]["nu"], names, "opt_state nu")
        for name, p in named:
            optimizer.state[p] = {"mu": mu[name].to(p.device), "nu": nu[name].to(p.device)}
    else:
        if len(entries) != 2 or set(entries[0]) != {"sum_of_squares"}:
            raise ValueError("opt_state does not hold adagrad's state")
        acc = _by_name(entries[0]["sum_of_squares"], names, "opt_state sum_of_squares")
        for name, p in named:
            optimizer.state[p] = {"sum_of_squares": acc[name].to(p.device)}
        # scale_by_rss keeps no count; the port's counts only the schedule's steps
        count = step if schedule_count is None else schedule_count
    if schedule_count is not None and schedule_count != count:
        raise NotImplementedError(
            f"opt_state's scale_by_schedule count {schedule_count} differs from the rule's "
            f"{count}; the port keeps one count for both ({_OTHER})"
        )
    group["count"] = count


def load_jax_train_state(tree: Mapping, state):
    """JAX's `TrainState` {step, params, opt_state, ema_params, rng} into the
    port's `state` (in place; returned): `params` and `ema_params` into
    `state.module` and `state.ema` (strict), `step`, and `opt_state` into the
    optimizer (`_load_jax_opt_state`). A rule the port lacks, or a chained
    schedule it cannot place, raises rather than load a wrong state.

    `rng` (a JAX PRNG key) is not carried: the port draws its noise from
    `torch.Generator`s, which a JAX key cannot seed to the same stream, so
    `state.generator` and `state.host_generator` keep their seeds."""
    missing = {"step", "params", "opt_state", "ema_params"} - set(tree)
    if missing:
        raise KeyError(f"not a JAX train state: {sorted(missing)} missing")
    step = int(np.asarray(tree["step"]))
    state.module.load_state_dict(from_jax_params(tree["params"]), strict=True)
    state.ema.load_state_dict(from_jax_params(tree["ema_params"]), strict=True)
    _load_jax_opt_state(tree["opt_state"], state.module, state.optimizer, step)
    state.step = step
    return state
