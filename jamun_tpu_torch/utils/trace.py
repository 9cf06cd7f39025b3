"""Named spans of the program on the profiler's clock.

`span(name)` marks a stretch of host time (a walk step, a denoiser forward,
a kernel launch, a wait for the device, a phase of the training step) as a
`torch.profiler.record_function` annotation. Under `torch.profiler.profile`
the spans land in the same Kineto trace as the operators and the kernels
they launch, so one clock holds both; parents come from nesting on the
thread. With no profiler recording, `span` returns one shared null context:
one flag read, no allocation, no operator, no synchronisation
(`record_function` itself costs about 12 us a call even then, so it is
never entered unconditionally).

Every name starts with `jamun.`, which keeps the program's spans apart from
torch's own annotations (`Optimizer.step#...`, `ProfilerStep#...`).
Spans are Python-side: code replayed from a captured CUDA graph emits none.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

__all__ = ["span"]

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` as a span while a profiler is
    recording, and the shared null context otherwise."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL
