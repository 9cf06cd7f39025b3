"""Checkpoint save and restore, and discovery (counterpart of
`jamun_tpu/train/checkpoints.py`).

The port writes `torch.save` of a dict of tensors and plain values: the
step, the parameters, the EMA parameters, the optimizer state and the two
generators' states. It loads with `torch.load(weights_only=True)`. The
directory layout is JAX's: an always-written `last.ckpt`, the top k by
`val/loss` as `step<N>.ckpt`, and `manifest.json` with the same keys.

`restore_checkpoint` reads both formats: the port's, and JAX's
(`flax.serialization.to_bytes` of its TrainState, a msgpack map). The first
bytes tell them apart: a `torch.save` file is a zip (`PK\x03\x04`), a flax
file starts with a msgpack map (0x80-0x8f, 0xde or 0xdf); any other start
raises. `read_flax_msgpack` decodes a flax file without flax, and
`params.load_jax_train_state` places JAX's state in the port's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np
import torch

from jamun_tpu_torch.params import load_jax_train_state
from jamun_tpu_torch.train.state import TrainState

__all__ = [
    "save_checkpoint", "restore_checkpoint", "read_flax_msgpack", "checkpoint_format",
    "find_checkpoint", "CheckpointManager",
]

_ZIP_MAGIC = b"PK\x03\x04"
# flax's msgpack extension codes (`flax.serialization._MsgpackExtType`)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_SCALAR = 1, 2, 3


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


def checkpoint_format(head: bytes) -> str:
    """"torch" or "flax" from a file's first bytes; anything else raises."""
    if head.startswith(_ZIP_MAGIC):
        return "torch"
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "flax"
    raise ValueError(
        f"not a checkpoint: the file starts with {head[:4]!r}, neither a torch.save zip "
        "nor a flax msgpack map"
    )


def _flax_array(data: bytes):
    """flax's array leaf: msgpack (shape, dtype name, C-order bytes). A
    bfloat16 leaf (numpy has no such dtype) becomes a torch.bfloat16 tensor
    of the same bits; every other leaf a numpy array."""
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype_name.decode())).reshape(shape).copy()


def _flax_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _flax_array(data)
    if code == _EXT_SCALAR:
        return _flax_array(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unknown msgpack extension type {code} in a flax checkpoint")


def _refuse_chunked(node, where: str = "") -> None:
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            raise NotImplementedError(
                f"flax checkpoint leaf {where!r} is an array above 2^30 bytes, which flax "
                "splits into chunks; no configuration reaches that size "
                "(ROADMAP.md queue A, 'The sample CLI')"
            )
        for k, v in node.items():
            _refuse_chunked(v, f"{where}/{k}")


def read_flax_msgpack(path: str) -> dict:
    """JAX's checkpoint (`flax.serialization.to_bytes`) as nested dicts, read
    without flax: a named tuple is a map of its fields, a tuple a map keyed
    "0", "1", ...; arrays are numpy arrays (torch.bfloat16 tensors for
    bfloat16 leaves)."""
    with open(path, "rb") as f:
        raw = f.read()
    if checkpoint_format(raw[:4]) != "flax":
        raise ValueError(f"{path!r} is not a flax msgpack checkpoint")
    tree = msgpack.unpackb(raw, ext_hook=_flax_ext, raw=False, strict_map_key=False)
    _refuse_chunked(tree)
    return tree


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Loads `path`, written by the port or by JAX, into `state` (in place)
    and returns it."""
    with open(path, "rb") as f:
        fmt = checkpoint_format(f.read(4))
    if fmt == "flax":
        tree = read_flax_msgpack(path)
        try:
            return load_jax_train_state(tree, state)
        except NotImplementedError:  # a state the port cannot place, named by its item
            raise
        except (RuntimeError, ValueError, KeyError) as e:
            raise _mismatch(path, e) from e
    data = torch.load(path, map_location="cpu", weights_only=True)
    try:
        state.module.load_state_dict(data["params"], strict=True)
        state.ema.load_state_dict(data["ema_params"], strict=True)
        state.optimizer.load_state_dict(data["opt_state"])
    except (RuntimeError, ValueError, KeyError) as e:
        raise _mismatch(path, e) from e
    state.generator.set_state(data["generator"])
    state.host_generator.set_state(data["host_generator"])
    state.step = int(data["step"])
    return state


def _mismatch(path: str, e: Exception) -> ValueError:
    return ValueError(
        f"checkpoint {path!r} does not match the current model/optimizer structure (it was "
        "probably saved with a different architecture config or an older code version). "
        f"Retrain or point resume/checkpoint settings at a compatible checkpoint. Original "
        f"error: {e}"
    )


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
        """The best entry's file in this directory. The manifest's "path" is
        relative to the directory the run trained from (as in JAX), so it
        is read for its file name only: a run sampled from elsewhere finds
        its own file, not one of the same name under the sampler's cwd."""
        if not self._entries:
            return None
        return os.path.join(self.directory, os.path.basename(self._entries[0]["path"]))

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
