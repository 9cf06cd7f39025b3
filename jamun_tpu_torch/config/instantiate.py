"""Config-driven object instantiation (`_target_` / `_partial_`), the port's
counterpart of `jamun_tpu/config/instantiate.py`.

The configs of the repository (`configs/experiment/*.yaml`) name JAX targets:
`jamun_tpu.*` and `optax.*`. The port resolves every target through one
fixed table, held as strings, so that nothing here imports `jamun_tpu`,
`jax`, `flax` or `optax`:

  - `jamun_tpu.<path>` -> `jamun_tpu_torch.<path>`;
  - optax's rules, schedules and its two wrappers that a config can build
    (`train/optim.py`: `RULES`, `SCHEDULES`, `WRAPPERS`) ->
    `jamun_tpu_torch.train.optim.*`; `optax.lbfgs` and `optax.polyak_sgd`,
    which need the loss in their update and so run in no trainer (JAX's
    raises TypeError), raise with their own title;
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
    "MultiSteps", "apply_if_finite", "lbfgs", "polyak_sgd",
)
_OPTAX = {f"optax.{name}": f"jamun_tpu_torch.train.optim.{name}" for name in _OPTAX_NAMES}
# targets the port does not have, by the title of their item
_UNPORTED = {
    "jamun_tpu_torch.train.optim.lbfgs": "Rules that need the loss",
    "jamun_tpu_torch.train.optim.polyak_sgd": "Rules that need the loss",
}
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
