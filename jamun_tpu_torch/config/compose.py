"""YAML config composition: defaults lists, dotted overrides, interpolation
(the port's own copy of `jamun_tpu/config/compose.py`, same behaviour).

A minimal stand-in for Hydra composition: a root config may declare
`defaults: [{group: name}, _self_]`; group files live at
`<config_dir>/<group>/<name>.yaml` and are merged at key `group` (or at the
root for `# @package _global_` files). Overrides use dotted paths
("model.arch.n_layers=3"; "+key=val" adds, "~key" deletes), and
`group/sub=name` replaces the node at group.sub with that file. One
difference from JAX's: `group=name` where `<config_dir>/group/name.yaml`
exists selects that file too, as Hydra does (`batch_sampler=vesde`); JAX's
sets the string "vesde" there, a config nothing can sample with.
Interpolation supports ${dotted.path}, ${env:VAR,default} and ${now:...}
timestamps. YAML is read with PyYAML's `safe_load`.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Dict, Optional, Sequence

import yaml

__all__ = ["compose", "merge", "resolve_interpolations", "apply_overrides", "load_yaml"]


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    cfg = yaml.safe_load(text) or {}
    cfg["__global_package__"] = bool(re.search(r"^#\s*@package\s+_global_", text, re.M))
    return cfg


def merge(base: Any, overlay: Any) -> Any:
    """Deep merge: overlay wins; dicts merge recursively."""
    if isinstance(base, dict) and isinstance(overlay, dict):
        out = dict(base)
        for k, v in overlay.items():
            out[k] = merge(base.get(k), v) if k in base else v
        return out
    return copy.deepcopy(overlay)


def _compose_file(config_dir: str, rel: str) -> Dict[str, Any]:
    path = os.path.join(config_dir, rel if rel.endswith(".yaml") else rel + ".yaml")
    cfg = load_yaml(path)
    cfg.pop("__global_package__", False)
    defaults = cfg.pop("defaults", None)
    if defaults is None:
        return cfg

    # Relative group paths resolve against this file's directory (Hydra
    # semantics); absolute ("/group") against the config root.
    rel_dir = os.path.dirname(rel)

    merged: Dict[str, Any] = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merged = merge(merged, cfg)
            self_merged = True
            continue
        if isinstance(entry, str):
            merged = merge(merged, _compose_file(config_dir, os.path.join(rel_dir, entry)))
            continue
        (group, name), = entry.items()
        if name is None:
            continue
        group = group.replace("override ", "")
        if group.startswith("/"):
            group_rel = group.lstrip("/")
        else:
            group_rel = os.path.join(rel_dir, group) if rel_dir else group
        names = name if isinstance(name, list) else [name]
        for nm in names:
            sub = _compose_file(config_dir, os.path.join(group_rel, str(nm)))
            sub_is_global = sub.pop("__global_package__", False) if isinstance(sub, dict) else False
            if sub_is_global:
                merged = merge(merged, sub)
            else:
                node: Dict[str, Any] = sub
                for part in reversed(group.lstrip("/").split("/")):
                    node = {part: node}
                merged = merge(merged, node)
    if not self_merged:
        merged = merge(merged, cfg)
    merged.pop("__global_package__", None)
    return merged


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(cfg: Dict[str, Any], dotted: str):
    node: Any = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(dotted)
        node = node[part]
    return node


def resolve_interpolations(cfg: Dict[str, Any]) -> Dict[str, Any]:
    def resolve_value(v: Any, depth=0):
        if isinstance(v, dict):
            return {k: resolve_value(x, depth) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve_value(x, depth) for x in v]
        if not isinstance(v, str) or depth > 10:
            return v

        def repl(m):
            expr = m.group(1)
            if expr.startswith("env:") or expr.startswith("oc.env:"):
                parts = expr.split(":", 1)[1].split(",", 1)
                return os.environ.get(parts[0], parts[1] if len(parts) > 1 else "")
            if expr.startswith("now:"):
                return datetime.datetime.now().strftime(expr.split(":", 1)[1] or "%Y-%m-%d_%H-%M-%S")
            try:
                val = _lookup(cfg, expr)
            except KeyError:
                return m.group(0)
            return str(resolve_value(val, depth + 1))

        full = _INTERP_RE.fullmatch(v)
        if full:
            expr = full.group(1)
            if not (expr.startswith(("env:", "oc.env:", "now:"))):
                try:
                    return resolve_value(_lookup(cfg, expr), depth + 1)
                except KeyError:
                    return v
        return _INTERP_RE.sub(repl, v)

    return resolve_value(cfg)


def _parse_scalar(s: str) -> Any:
    return yaml.safe_load(s)


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        ov = ov.lstrip("+")
        if ov.startswith("~"):
            path = ov[1:].split("=")[0]
            node = cfg
            parts = path.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node.pop(parts[-1], None)
            continue
        key, _, val = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_scalar(val)
    return cfg


def compose(
    config_dir: str,
    config_name: str,
    overrides: Sequence[str] = (),
    experiment_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Compose <config_dir>/<config_name>.yaml with optional
    `experiment=<name>` overlays from experiment_dir and dotted overrides."""
    overrides = list(overrides)
    experiments = [o.split("=", 1)[1] for o in overrides if o.startswith("experiment=")]
    overrides = [o for o in overrides if not o.startswith("experiment=")]
    # Hydra-style group overrides: `model/arch=ophiuchus` REPLACES the config
    # node at model.arch with <config_dir>/model/arch/ophiuchus.yaml.
    def is_group(o: str) -> bool:
        key, _, name = o.partition("=")
        return "/" in key or (
            "." not in key and os.path.isfile(os.path.join(config_dir, key, f"{name}.yaml"))
        )

    group_ovs = [o for o in overrides if "=" in o and not o.startswith("~") and is_group(o)]
    overrides = [o for o in overrides if o not in group_ovs]

    cfg = _compose_file(config_dir, config_name)
    for exp in experiments:
        exp_dir = experiment_dir or os.path.join(config_dir, "experiment")
        overlay = _compose_file(exp_dir, exp)
        overlay.pop("__global_package__", None)
        cfg = merge(cfg, overlay)
    for ov in group_ovs:
        group, _, name = ov.partition("=")
        content = _compose_file(config_dir, os.path.join(group, name))
        content.pop("__global_package__", None)
        node = cfg
        parts = group.strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = content
    cfg = apply_overrides(cfg, overrides)
    cfg.pop("__global_package__", None)
    return resolve_interpolations(cfg)
