"""Run one cell of the benchmark with the program's spans read:

    python3 benchmark/spanrun.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, as `benchmark/run.py ... --trace 1`, with the
profiled slice read by `benchmark/spans.py`. The result line (the last of
standard output) is `run.py`'s, and besides holds the metrics of
`benchmark/span_metrics.json` that apply to the cell, and in `breakdown`
`idle_gaps_by_span` (the slice's idle time by the innermost program span
open at each gap) and `span_totals` (per span name: count, host seconds,
device seconds launched inside). A program without spans gives none of
these metrics, and its idle time is all outside a program span.
"""

import time

T_START = time.perf_counter()

import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cell, seconds, trace, since_start, _run):
    """`_run` (`harness.run`) traced, with the span metrics added to the
    cell and the slice read with the program's spans."""
    from benchmark import devtrace, spans

    with open(os.path.join(ROOT, "benchmark", "span_metrics.json")) as f:
        cell.per_layer = cell.per_layer + [m for m in json.load(f) if cell.name in m["workloads"]]
    taken = {}

    def profile_slice(fn, steps):
        taken["slice"] = spans.profile_slice(fn, steps)
        return taken["slice"]

    plain, devtrace.profile_slice = devtrace.profile_slice, profile_slice  # `_run` imports it at its call
    try:
        out = _run(cell, seconds, True, since_start)
    finally:
        devtrace.profile_slice = plain
    out["breakdown"]["idle_gaps_by_span"] = taken["slice"].idle_gaps_by_span(n=50)
    out["breakdown"]["span_totals"] = taken["slice"].span_totals(n=50)
    return out


def main(argv) -> int:
    # as `run.py`: library caches inside the checkout, the checkout's root on the path
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path[0] = ROOT
    from benchmark import harness

    harness.run = functools.partial(run, _run=harness.run)
    return harness.main(argv + ["--trace", "1"], T_START)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
