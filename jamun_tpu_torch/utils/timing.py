"""Wall-clock timing of chained device work (counterpart of
`jamun_tpu/utils/timing.py`).

JAX's rules, shared by every timing script: sync before reading the clock,
reject a time below a physical floor (1 us per chained step) and retry a
bounded number of times, and report failure as None rather than a number.
JAX syncs by fetching a value, because its TPU link could acknowledge a
dispatch before it ran; on the card `torch.cuda.synchronize` waits for the
device's queue itself, so the port syncs with it, before and after the run.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import torch

from jamun_tpu_torch.utils.device import resolve_device

__all__ = ["timed_chain", "MIN_S_PER_STEP", "synchronize"]

MIN_S_PER_STEP = 1e-6  # no model step finishes in under 1 us


def synchronize(device: torch.device) -> None:
    """Wait for every queued kernel of `device` (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_chain(
    run: Callable[[], None],
    steps: int,
    *,
    min_s_per_step: float = MIN_S_PER_STEP,
    max_tries: int = 6,
    device: Optional[Union[str, torch.device]] = None,
) -> Optional[float]:
    """Time `run()` on `device` (`utils.device.resolve_device`: the card
    unless "cpu"), synchronized before and after, and return the first
    elapsed seconds at or above `steps * min_s_per_step`, or None if every
    one of `max_tries` tries was below it. Callers must report None as a
    failed timing, never as a number."""
    dev = resolve_device(device)
    for _ in range(max_tries):
        synchronize(dev)
        t0 = time.perf_counter()
        run()
        synchronize(dev)
        dt = time.perf_counter() - t0
        if dt >= steps * min_s_per_step:
            return dt
    return None
