"""A profiled slice and what the per-layer metrics read from it.

`profile_slice` runs a callable under `torch.profiler` (host and device
activities) inside a `bench_slice` annotation, writes the Chrome trace under
the run's temporary directory and reads it back. The device's busy time is
the union of the intervals of its kernels, copies and fills, not their sum,
so that work on two streams at once counts once. The slice's wall time runs
from the annotation's start to the later of its end and the last device
event's end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["Slice", "profile_slice"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_ANNOTATION = "bench_slice"


@dataclasses.dataclass
class Slice:
    device: List[dict]  # kernels, copies, fills: name, ts, dur (us)
    host: List[dict]  # host operators: name, ts, dur, tid
    start: float  # us
    end: float  # us
    steps: int  # the slice's steps (walk updates or training steps)

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        return sum(e["dur"] for e in self.device if e["cat"] == "kernel" and match(e["name"])) * 1e-6

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] * 1e-6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time between device intervals inside the slice, summed by
        the innermost host operator running at each gap's midpoint (the
        shortest that holds it, the first listed among equals)."""
        edges = [self.start]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end)
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        mids = np.array([0.5 * (a + b) for a, b in gaps])
        order = np.argsort(mids, kind="stable")
        sorted_mids = mids[order]
        owner = np.full(len(gaps), -1)
        # longest operators first, so that an inner one overwrites the ones around it
        for i in sorted(range(len(self.host)), key=lambda i: (-self.host[i]["dur"], -i)):
            h = self.host[i]
            lo = np.searchsorted(sorted_mids, h["ts"], side="left")
            hi = np.searchsorted(sorted_mids, h["ts"] + h["dur"], side="right")
            owner[order[lo:hi]] = i
        by: Dict[str, float] = {}
        for (a, b), i in zip(gaps, owner):
            name = self.host[i]["name"] if i >= 0 else "host outside an operator"
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile_slice(fn: Callable[[], None], steps: int) -> Slice:
    """Run fn once under the profiler and read its trace. Raises where the
    trace holds no device activity (the profiler could not reach the card)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_ANNOTATION):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    device, host, span = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = {"name": e.get("name", ""), "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0)), "cat": cat}
        if cat in _DEVICE_CATS:
            device.append(item)
        elif cat == "user_annotation" and item["name"] == _ANNOTATION and span is None:
            span = (item["ts"], item["ts"] + item["dur"])
        elif cat == "cpu_op":
            host.append(item)
    if not device or span is None:
        raise RuntimeError("the profiler's trace holds no device activity for the slice")
    end = max(span[1], max(e["ts"] + e["dur"] for e in device))
    device = [e for e in device if e["ts"] >= span[0]]
    return Slice(device=device, host=host, start=span[0], end=end, steps=steps)
