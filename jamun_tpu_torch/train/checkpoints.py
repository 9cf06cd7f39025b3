"""Checkpoint save and restore, and discovery (counterpart of
`jamun_tpu/train/checkpoints.py`).

A checkpoint is `torch.save` of a dict of tensors and plain values: the step,
the parameters, the EMA parameters, the optimizer state and the two
generators' states. It loads with `torch.load(weights_only=True)`. The
directory layout is JAX's: an always-written `last.ckpt`, the top k by
`val/loss` as `step<N>.ckpt`, and `manifest.json` with the same keys.
Reading JAX's flax-msgpack checkpoints is not ported (ROADMAP.md queue A,
'The sample CLI').
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

from jamun_tpu_torch.train.state import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "find_checkpoint", "CheckpointManager"]


def save_checkpoint(path: str, state: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(
        {
            "step": int(state.step),
            "params": state.module.state_dict(),
            "ema_params": state.ema.state_dict(),
            "opt_state": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            "host_generator": state.host_generator.get_state(),
        },
        path,
    )


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Loads `path` into `state` (in place) and returns it."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    try:
        state.module.load_state_dict(data["params"], strict=True)
        state.ema.load_state_dict(data["ema_params"], strict=True)
        state.optimizer.load_state_dict(data["opt_state"])
    except (RuntimeError, ValueError, KeyError) as e:
        raise ValueError(
            f"checkpoint {path!r} does not match the current model/optimizer structure (it was "
            "probably saved with a different architecture config or an older code version). "
            f"Retrain or point resume/checkpoint settings at a compatible checkpoint. Original "
            f"error: {e}"
        ) from e
    state.generator.set_state(data["generator"])
    state.host_generator.set_state(data["host_generator"])
    state.step = int(data["step"])
    return state


class CheckpointManager:
    """top-k on a monitored metric + always-updated last.ckpt, with manifest."""

    def __init__(self, directory: str, top_k: int = 5, monitor: str = "val/loss", mode: str = "min"):
        self.directory = directory
        self.top_k = top_k
        self.monitor = monitor
        self.mode = mode
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")
        self._entries: List[Dict[str, Any]] = []
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._entries = json.load(f).get("entries", [])

    def _write_manifest(self):
        with open(self._manifest_path, "w") as f:
            json.dump({"entries": self._entries, "monitor": self.monitor}, f, indent=2)

    def save(self, state: TrainState, step: int, metrics: Optional[Dict[str, float]] = None):
        last_path = os.path.join(self.directory, "last.ckpt")
        save_checkpoint(last_path, state)
        metric_val = (metrics or {}).get(self.monitor)
        if metric_val is not None:
            path = os.path.join(self.directory, f"step{step}.ckpt")
            save_checkpoint(path, state)
            self._entries.append({"step": step, "path": path, self.monitor: float(metric_val)})
            sign = 1 if self.mode == "min" else -1
            self._entries.sort(key=lambda e: sign * e[self.monitor])
            for stale in self._entries[self.top_k :]:
                if os.path.exists(stale["path"]):
                    os.remove(stale["path"])
            self._entries = self._entries[: self.top_k]
        self._write_manifest()

    def best_path(self) -> Optional[str]:
        return self._entries[0]["path"] if self._entries else None

    def last_path(self) -> Optional[str]:
        p = os.path.join(self.directory, "last.ckpt")
        return p if os.path.exists(p) else None


def find_checkpoint(directory: str, checkpoint_type: str = "best_so_far") -> str:
    """Resolve a checkpoint path from a run/checkpoint directory:
    "last", "best_so_far" or a "*.ckpt" path (relative to `directory`)."""
    if checkpoint_type.endswith(".ckpt"):
        path = checkpoint_type if os.path.isabs(checkpoint_type) else os.path.join(directory, checkpoint_type)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return path
    mgr = CheckpointManager(directory)
    if checkpoint_type == "last":
        path = mgr.last_path()
    elif checkpoint_type == "best_so_far":
        path = mgr.best_path() or mgr.last_path()
    else:
        raise ValueError(f"unknown checkpoint_type {checkpoint_type!r}")
    if path is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    return path
