"""Process-group set-up and per-host helpers (counterpart of
`jamun_tpu/parallel/distributed.py`).

JAX's multi-host runtime becomes a `torch.distributed` process group with
one rank per card. The group is named by torchrun's variables
(`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`), by JAX's
(`JAX_COORDINATOR_ADDRESS` -> the address, `JAX_NUM_PROCESSES` -> the world
size, `JAX_PROCESS_ID` -> the rank), or by the arguments:

    torchrun --nproc_per_node=K -m jamun_tpu_torch.cmdline.train ...

The backend is NCCL for the card and gloo for the CPU; gloo with CUDA
tensors only when the caller names it (two ranks on one card, which NCCL
refuses). Unlike JAX's `initialize_distributed`, a failed set-up raises:
nothing falls back to one process or to another backend.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("jamun_tpu_torch")

__all__ = [
    "initialize_distributed", "is_multihost", "process_index", "host_log", "world_size",
    "rank", "local_rank", "default_backend",
]


def default_backend(device_type: str) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout: float = 600.0,
) -> bool:
    """Join the process group, and return whether one is set up.

    A no-op with one process (no world size given, or 1), and when a group
    already exists. `coordinator_address` is "host:port" (or torchrun's
    `MASTER_ADDR`/`MASTER_PORT`); `init_method` ("file://...", "tcp://...")
    takes its place. `backend` defaults to `default_backend` of this
    process's device; under NCCL the process takes the card `LOCAL_RANK`.
    `timeout` (seconds) bounds every collective, the rendezvous included."""
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if process_id is None:
        raise ValueError(f"a world of {num_processes} processes needs this process's rank (RANK)")
    if init_method is None:
        address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
        if address is None and os.environ.get("MASTER_ADDR"):
            address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        if address is None:
            raise ValueError("no coordinator address (MASTER_ADDR/MASTER_PORT) or init_method")
        init_method = f"tcp://{address}"
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available() else "cpu")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    host_log("process group up: rank %d of %d, backend %s", rank(), world_size(), backend)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index on its node (torchrun's `LOCAL_RANK`), 0 alone."""
    return _env_int("LOCAL_RANK") or 0


def is_multihost() -> bool:
    """Whether the group spans more than one node."""
    return world_size() > (_env_int("LOCAL_WORLD_SIZE") or world_size())


def process_index() -> int:
    """The node's index (torchrun's `GROUP_RANK`), not the card's rank: one
    node behaves as one JAX host, whose `process_index()` is the same for
    each of its devices."""
    if not dist.is_initialized():
        return 0
    node = _env_int("GROUP_RANK")
    if node is not None:
        return node
    return rank() // (_env_int("LOCAL_WORLD_SIZE") or world_size())


def host_log(msg: str, *args) -> None:
    """Logging with the node's index and the rank in front."""
    log.info("[host %d rank %d] " + msg, process_index(), rank(), *args)
