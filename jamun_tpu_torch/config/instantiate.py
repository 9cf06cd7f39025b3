"""Config-driven object instantiation (`_target_` / `_partial_`), the port's
counterpart of `jamun_tpu/config/instantiate.py`.

The configs of the repository (`configs/experiment/*.yaml`) name JAX targets:
`jamun_tpu.*` and `optax.*`. The port resolves every target through one
fixed table, held as strings, so that nothing here imports `jamun_tpu`,
`jax`, `flax` or `optax`:

  - `jamun_tpu.<path>` -> `jamun_tpu_torch.<path>`;
  - optax's rules, schedules, `MultiSteps` and `apply_if_finite`
    (`train/optim.py`: `RULES`, `SCHEDULES`, `WRAPPERS`) ->
    `jamun_tpu_torch.train.optim.*`; its transforms given alone, its
    combinators and the functions a config hands them
    (`train/optim_transforms.py`) -> `jamun_tpu_torch.train.optim_transforms.*`;
    `optax.contrib.<name>` (`train/optim_contrib.py`) ->
    `jamun_tpu_torch.train.optim_contrib.*`;
  - optax's targets that JAX's trainer cannot run either (rules that need
    the loss or per-example gradients, `lookahead`, `chain` and
    `named_chain`, which take their rules by position where `instantiate`
    passes keywords, and fail empty, and `contrib.scale_by_muon` alone,
    whose update without dimension numbers fails) raise with the title
    their item shares with the reference (`_REFUSED`);
  - a `jamun_tpu_torch.<path>` target stands as it is (the port's own
    `config/defaults/`).

A target outside the table, or one the port lacks, raises
`NotImplementedError` naming its `ROADMAP.md` item by title.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any, Dict, List, Optional

__all__ = ["port_path", "resolve_target", "locate", "instantiate", "instantiate_dict_cfg"]

# optax's rules, schedules and wrappers the port has (`train/optim.py`)
_OPTAX_NAMES = (
    "adam", "adamw", "adagrad", "nadam", "nadamw", "adamax", "lion", "sgd", "rmsprop",
    "adabelief", "adadelta", "adafactor", "adamaxw", "adan", "amsgrad", "fromage", "lamb",
    "lars", "noisy_sgd", "novograd", "optimistic_adam", "optimistic_adam_v2",
    "optimistic_gradient_descent", "radam", "rprop", "sign_sgd", "sm3", "yogi",
    "constant_schedule", "linear_schedule", "cosine_decay_schedule",
    "warmup_cosine_decay_schedule", "exponential_decay", "cosine_onecycle_schedule",
    "join_schedules", "linear_onecycle_schedule", "piecewise_constant_schedule",
    "piecewise_interpolate_schedule", "polynomial_schedule", "sgdr_schedule",
    "warmup_constant_schedule", "warmup_exponential_decay_schedule",
    "MultiSteps", "apply_if_finite",
)
# optax's transforms given alone, its combinators, and the functions a config
# passes to them (`train/optim_transforms.py`)
_TRANSFORM_NAMES = (
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
    "masked", "multi_transform", "partition", "freeze", "selective_transform", "flatten",
    "conditionally_transform", "conditionally_mask", "with_extra_args_support",
    "inject_hyperparams", "inject_stateful_hyperparams",
    "skip_not_finite", "skip_large_updates", "global_norm",
)
# optax.contrib's rules, wrappers and transforms (`train/optim_contrib.py`)
_CONTRIB_NAMES = (
    "acprop", "ademamix", "simplified_ademamix", "adopt", "cocob", "dadapt_adamw", "dog", "dowg",
    "muon", "prodigy", "schedule_free_adamw", "schedule_free_sgd", "normalize",
    "mechanize", "schedule_free", "sam", "split_real_and_imaginary",
    "scale_by_acprop", "scale_by_ademamix", "scale_by_adopt", "scale_by_cocob",
    "scale_by_simplified_ademamix",
)
# optax's targets that JAX's trainer cannot run either, by the title of their
# item (ROADMAP.md section C): its train step calls `update(grads, state,
# params)` on the parameter tree and nothing more
_LOSS = "Rules that need the loss"
_PER_EXAMPLE = "Rules that need per-example gradients"
_CANNOT_RUN = "Targets JAX's trainer cannot run"
_REFUSED = {
    **{f"optax.{n}": _LOSS for n in (
        "lbfgs", "polyak_sgd", "scale_by_polyak", "scale_by_backtracking_linesearch",
        "scale_by_zoom_linesearch")},
    **{f"optax.contrib.{n}": _LOSS for n in (
        "momo", "momo_adam", "reduce_on_plateau", "sophia", "hutchinson_estimator_diag_hessian")},
    **{f"optax.contrib.{n}": _PER_EXAMPLE for n in ("dpsgd", "differentially_private_aggregate")},
    **{f"optax.{n}": _CANNOT_RUN for n in ("lookahead", "chain", "named_chain")},
    "optax.contrib.scale_by_muon": _CANNOT_RUN,
}


def _module_of(path: str) -> str:
    """The port's module for an optax target: optax.contrib's, optax's
    transforms, or its rules, schedules and wrappers."""
    name = path.rpartition(".")[2]
    if path.startswith("optax.contrib."):
        return "jamun_tpu_torch.train.optim_contrib"
    return ("jamun_tpu_torch.train.optim_transforms" if name in _TRANSFORM_NAMES
            else "jamun_tpu_torch.train.optim")


_OPTAX = {path: f"{_module_of(path)}.{path.rpartition('.')[2]}" for path in (
    *(f"optax.{n}" for n in (*_OPTAX_NAMES, *_TRANSFORM_NAMES)),
    *(f"optax.contrib.{n}" for n in _CONTRIB_NAMES), *_REFUSED)}
# the port's paths of the refused targets (no module of the port has them)
_UNPORTED = {_OPTAX[path]: title for path, title in _REFUSED.items()}
_OTHER = "Other config targets"


def _roadmap(title: str) -> str:
    return f"ROADMAP.md queue A, '{title}'"


def port_path(path: str) -> Optional[str]:
    """The table above: the port's dotted path for a config target, or None
    for a target outside it."""
    if path.startswith("jamun_tpu_torch."):
        return path
    if path.startswith("jamun_tpu."):
        return "jamun_tpu_torch." + path[len("jamun_tpu."):]
    return _OPTAX.get(path)


def resolve_target(path: str) -> str:
    """`port_path`, for a target the port has."""
    port = port_path(path)
    if port is None:
        raise NotImplementedError(
            f"config target {path!r} is outside the port's table ({_roadmap(_OTHER)})"
        )
    if port in _UNPORTED:
        raise NotImplementedError(f"{path!r} is not ported ({_roadmap(_UNPORTED[port])})")
    return port


def locate(path: str):
    """The object a config target names, through `resolve_target`."""
    port = resolve_target(path)
    module_path, _, attr = port.rpartition(".")
    missing = NotImplementedError(
        f"config target {path!r} ({port}) is not in the port ({_roadmap(_OTHER)})"
    )
    try:
        module = importlib.import_module(module_path)
    except ModuleNotFoundError as e:
        if e.name is None or not module_path.startswith(e.name):
            raise  # a module the target's module imports is missing
        raise missing from e
    if not hasattr(module, attr):
        raise missing
    return getattr(module, attr)


def instantiate(cfg: Any, **extra_kwargs) -> Any:
    """Recursively build objects from dicts with `_target_` keys;
    `extra_kwargs` go to the outermost target."""
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}
    target = locate(cfg["_target_"])
    kwargs = {
        k: instantiate(v)
        for k, v in cfg.items()
        if not (k.startswith("_") and k.endswith("_"))
    }
    kwargs.update(extra_kwargs)
    if cfg.get("_partial_", False):
        return functools.partial(target, **kwargs)
    return target(**kwargs)


def instantiate_dict_cfg(cfg: Dict[str, Any], verbose: bool = False) -> List[Any]:
    """Every entry of a dict of configs that has a `_target_`, instantiated,
    in the dict's order (JAX's `config/instantiate.py:57-65`; `verbose` is
    taken and unused there too)."""
    return [instantiate(sub) for sub in (cfg or {}).values()
            if isinstance(sub, dict) and "_target_" in sub]
