"""Config-driven object instantiation (`_target_` / `_partial_`), the port's
counterpart of `jamun_tpu/config/instantiate.py`.

The configs of the repository (`configs/experiment/*.yaml`) name JAX targets:
`jamun_tpu.*` and `optax.*`. The port resolves every target through one
fixed table, held as strings, so that nothing here imports `jamun_tpu`,
`jax`, `flax` or `optax`:

  - `jamun_tpu.<path>` -> `jamun_tpu_torch.<path>`;
  - `optax.adam`, `optax.adamw`, `optax.adagrad` -> `jamun_tpu_torch.train.optim.*`;
  - a `jamun_tpu_torch.<path>` target stands as it is (the port's own
    `config/defaults/`).

A target outside the table, or one the port lacks, raises
`NotImplementedError` naming its `ROADMAP.md` item by title.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any, Optional

__all__ = ["port_path", "resolve_target", "locate", "instantiate"]

_OPTAX = {
    "optax.adam": "jamun_tpu_torch.train.optim.adam",
    "optax.adamw": "jamun_tpu_torch.train.optim.adamw",
    "optax.adagrad": "jamun_tpu_torch.train.optim.adagrad",
}
# targets of the JAX package that the port lacks, by the title of their
# item (none since the port has every target of the repo's configs)
_UNPORTED: dict = {}
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

