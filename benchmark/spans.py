"""The program's own spans in a profiled slice.

The port marks its layers with `torch.profiler.record_function` spans whose
names start with `jamun.` (`jamun_tpu_torch/utils/trace.py`: the sample
batch, the walk step, the denoiser forward and its regime, each kernel
launch, the host's waits, the phases of the training step). They land in
the same Kineto trace as the kernels, on one clock. `profile_slice` here
runs a callable as `devtrace.profile_slice` does and reads the same trace
into a `SpanSlice`: a `devtrace.Slice` whose device, host, start and end
are read exactly as there, with, besides, the program's spans, each device
operation's correlation id and the host time of the CUDA runtime or driver
call that launched it. A slice of a program without spans has none, and
every reader of them then finds nothing.

Run a cell with these readings: `benchmark/spanrun.py`.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.devtrace import _ANNOTATION, _DEVICE_CATS, Slice

__all__ = ["SpanSlice", "profile_slice", "read_trace", "find", "PREFIX", "OUTSIDE"]

PREFIX = "jamun."
OUTSIDE = "outside a program span"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class SpanSlice(Slice):
    spans: List[dict] = dataclasses.field(default_factory=list)  # `jamun.` spans: name, ts, dur, tid (us)
    launches: Dict[int, float] = dataclasses.field(default_factory=dict)  # correlation id -> host ts (us)

    def _matching(self, patterns: Tuple[str, ...]) -> List[Tuple[float, float]]:
        """The merged intervals of the spans whose names match any pattern
        (`fnmatch`: `jamun.host.wait:*`)."""
        spans = sorted((s["ts"], s["ts"] + s["dur"]) for s in self.spans
                       if any(fnmatch.fnmatchcase(s["name"], p) for p in patterns))
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @staticmethod
    def _inside(times: np.ndarray, intervals: List[Tuple[float, float]]) -> np.ndarray:
        if not intervals or not len(times):
            return np.zeros(len(times), dtype=bool)
        starts = np.array([a for a, _ in intervals])
        ends = np.array([b for _, b in intervals])
        k = np.searchsorted(starts, times, side="right") - 1
        return (k >= 0) & (times <= ends[np.maximum(k, 0)])

    def span_s(self, pattern: str) -> List[float]:
        """The durations of the spans whose names match, in seconds, in order."""
        return [s["dur"] * 1e-6 for s in sorted(self.spans, key=lambda s: s["ts"])
                if fnmatch.fnmatchcase(s["name"], pattern)]

    def wall_in(self, *patterns: str) -> float:
        """Seconds of the slice's wall time inside a matching span."""
        return sum(max(0.0, min(b, self.end) - max(a, self.start))
                   for a, b in self._matching(patterns)) * 1e-6

    def device_s_in(self, *patterns: str) -> float:
        """Device seconds of the operations launched inside a matching span:
        the host time of the runtime call with the operation's correlation
        id lies inside it, on whichever thread made the call (autograd's
        device thread launches the backward's kernels)."""
        ops = [e for e in self.device if e.get("correlation") in self.launches]
        t = np.array([self.launches[e["correlation"]] for e in ops])
        inside = self._inside(t, self._matching(patterns))
        return sum(e["dur"] for e, k in zip(ops, inside) if k) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals between device intervals inside the slice
        (those `idle_gaps` sums)."""
        edges = [self.start]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end)
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def idle_in(self, *patterns: str) -> float:
        """Idle seconds of the gaps whose midpoint lies inside a matching span."""
        gaps = self.gaps()
        mids = np.array([0.5 * (a + b) for a, b in gaps])
        inside = self._inside(mids, self._matching(patterns))
        return sum(b - a for (a, b), k in zip(gaps, inside) if k) * 1e-6

    def idle_gaps_by_span(self, n: int = 10) -> List[list]:
        """The idle time between device intervals inside the slice, summed by
        the innermost program span open at each gap's midpoint (the shortest
        that holds it, on any thread; the first listed among equals), by the
        midpoint rule of `idle_gaps`; `OUTSIDE` for the rest."""
        gaps = self.gaps()
        mids = np.array([0.5 * (a + b) for a, b in gaps])
        order = np.argsort(mids, kind="stable")
        sorted_mids = mids[order]
        owner = np.full(len(gaps), -1)
        # longest spans first, so that an inner one overwrites the ones around it
        for i in sorted(range(len(self.spans)), key=lambda i: (-self.spans[i]["dur"], -i)):
            s = self.spans[i]
            lo = np.searchsorted(sorted_mids, s["ts"], side="left")
            hi = np.searchsorted(sorted_mids, s["ts"] + s["dur"], side="right")
            owner[order[lo:hi]] = i
        by: Dict[str, float] = {}
        for (a, b), i in zip(gaps, owner):
            name = self.spans[i]["name"] if i >= 0 else OUTSIDE
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def span_totals(self, n: int = 20) -> List[list]:
        """Per span name: [name, spans, seconds, seconds of device time
        launched inside them], the longest first."""
        by: Dict[str, List[float]] = {}
        for s in self.spans:
            c = by.setdefault(s["name"], [0, 0.0])
            c[0] += 1
            c[1] += s["dur"] * 1e-6
        rows = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
        return [[k[:120], c[0], c[1], self.device_s_in(k)] for k, c in rows]


def read_trace(events: List[dict], steps: int) -> SpanSlice:
    """A slice from a Chrome trace's events, as `devtrace.profile_slice`
    reads it, with the program's spans and the launches."""
    device, host, spans, launches, span = [], [], [], {}, None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = {"name": e.get("name", ""), "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0)), "cat": cat}
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            if corr is not None:
                item["correlation"] = corr
            device.append(item)
        elif cat == "user_annotation" and item["name"] == _ANNOTATION and span is None:
            span = (item["ts"], item["ts"] + item["dur"])
        elif cat == "user_annotation" and item["name"].startswith(PREFIX):
            spans.append({"name": item["name"], "ts": item["ts"], "dur": item["dur"], "tid": e.get("tid")})
        elif cat == "cpu_op":
            host.append(item)
        elif cat in _LAUNCH_CATS and corr is not None:
            launches[corr] = item["ts"]
    if not device or span is None:
        raise RuntimeError("the profiler's trace holds no device activity for the slice")
    end = max(span[1], max(e["ts"] + e["dur"] for e in device))
    device = [e for e in device if e["ts"] >= span[0]]
    return SpanSlice(device=device, host=host, start=span[0], end=end, steps=steps, spans=spans,
                     launches=launches)


def profile_slice(fn: Callable[[], None], steps: int) -> SpanSlice:
    """`devtrace.profile_slice`, read with the program's spans."""
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
    return read_trace(events, steps)


def find(r: dict, kind: str) -> Optional[SpanSlice]:
    """The readings' slice where it is of `kind` and holds program spans."""
    s = r["slice"]
    return s if r["kind"] == kind and getattr(s, "spans", None) else None
