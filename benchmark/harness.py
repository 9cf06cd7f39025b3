"""The benchmark's harness: one run of one cell, driven by data.

Everything about a cell is found by name:
  BENCHMARK.json                 the cell (workload), its metrics and bounds
  benchmark/configs/<config>.json  the model configuration (sizes, as run)
  benchmark/traffic/<traffic>.json the traffic mix: its `kind` and parameters
  benchmark/traffic/<kind>.py      the general generator of that kind (`Driver`)
  benchmark/limits/<workload>.json the limit of each number the check compares
  benchmark/metrics/<metric>.py    the reader of each per-layer metric

A run: set-up (weights made on the device from the seed, the program built,
its shapes warmed up), the measured window, with `--trace 1` the readings
of the per-layer metrics (the window's operations, a host-timed slice and a
profiled slice), then the program's state freed and the reference's check.
The result is one JSON line, the last of standard output.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

__all__ = [
    "Cell", "load_spec", "find_cell", "load_module", "metric_reader", "run", "forbidden_modules", "judge",
    "driver_for", "main",
]

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "jamun_tpu")


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    root: Path
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    device: object = None
    tmpdir: str = ""

    @property
    def name(self) -> str:
        return self.workload["name"]

    def make_weights(self):
        """The configuration's random weights, made on the device
        (`benchmark/weights.py`) from the mix's `weight_seed` where it has
        one (every run then does the same work), else from the run's seed,
        under the reference's parameter names."""
        from benchmark.reference.model import E3Conv as RefNet
        from benchmark.weights import make_weights

        import torch

        with torch.device("meta"):
            shapes = [(n, tuple(p.shape)) for n, p in RefNet(self.config["arch"]).named_parameters()]
        seed = int(self.mix.get("weight_seed", self.seed))
        return make_weights(shapes, seed, self.device, float(self.config["assumed"]["output_gain"]))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(root: Path, workload: str, seed: int) -> Cell:
    """The cell named `workload`, with everything its run reads."""
    spec = load_spec(root)
    entries = [w for w in spec["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    wl = entries[0]
    bench = root / "benchmark"
    limits_path = bench / "limits" / f"{workload}.json"
    return Cell(
        root=root, workload=wl,
        config=_read_json(bench / "configs" / f"{wl['config']}.json"),
        mix=_read_json(bench / "traffic" / f"{wl['traffic']}.json"),
        limits=_read_json(limits_path) if limits_path.is_file() else {},
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
        seed=int(seed),
    )


def driver_for(cell: Cell):
    kind = cell.mix["kind"]
    mod = load_module(cell.root / "benchmark" / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")
    return mod.Driver(cell)


def metric_reader(root: Path, name: str) -> Callable[[dict], Optional[float]]:
    mod = load_module(root / "benchmark" / "metrics" / f"{name}.py", "benchmark_metric_" + name.replace(".", "_"))
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number finite and within its limit."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits
    )


def run(cell: Cell, seconds: float, trace: bool, since_start: Callable[[], float]) -> Optional[dict]:
    """One run of the cell on `cell.device`; returns the result object.
    `since_start()` gives the seconds since the run was started."""
    import torch

    from benchmark.devtrace import profile_slice
    from benchmark.reference.precision import reference_matmul_policy

    on_card = cell.device.type == "cuda"
    driver = driver_for(cell)
    marks = {}

    def window_start():
        if on_card:
            torch.cuda.synchronize(cell.device)
            marks["setup_peak"] = torch.cuda.max_memory_allocated(cell.device)
            torch.cuda.reset_peak_memory_stats(cell.device)
        marks["setup_s"] = since_start()

    driver.setup()
    e2e = driver.run(seconds, window_start, keep_frames=trace)
    e2e["setup_s"] = marks["setup_s"]
    peak = window_peak = 0
    if on_card:
        window_peak = torch.cuda.max_memory_allocated(cell.device)
        peak = max(marks["setup_peak"], window_peak)
    out = {"correct": False, "attempted": driver.attempted(), "failed": driver.failed()}
    if trace:
        readings = driver.readings(profile_slice)
        readings.update(window_peak_bytes=window_peak, chips=int(cell.workload["chips"]))
        if on_card:
            peak = max(peak, torch.cuda.max_memory_allocated(cell.device))
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(cell.root, m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        sl = readings["slice"]
        device_extra = {"busy_s": sl.busy_s, "window_s": sl.wall_s}
        breakdown = {"device_ops": sl.top_device_ops(), "idle_gaps": sl.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
        device_extra, breakdown = {}, None
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference_matmul_policy()
    numbers = driver.check()
    out["correct"] = judge(numbers, cell.limits)
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
        "count": int(cell.workload["chips"]),
        "memory_peak_bytes": int(peak),
        **device_extra,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": numbers[k], "limit": cell.limits.get(k)} for k in numbers}
    return out


def _print_checks(result: dict) -> None:
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark on this machine's cards.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    cell = find_cell(root, args.workload, args.seed)

    import torch

    chips = int(cell.workload["chips"])
    if chips != 1:
        print(f"benchmark: {cell.name} asks for {chips} cards; this harness runs cells of one card",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if not cell.limits:
        print(f"benchmark: no limits for {cell.name} (benchmark/limits/{cell.name}.json)", file=sys.stderr)
        return 2
    try:
        import jamun_tpu_torch
    except ImportError as e:
        print(f"benchmark: the program (jamun_tpu_torch) is not in this checkout: {e}", file=sys.stderr)
        return 2
    if not Path(jamun_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"benchmark: jamun_tpu_torch comes from {jamun_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    from jamun_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    cell.device = torch.device("cuda", 0)
    cell.tmpdir = tempfile.mkdtemp(prefix="bench_run_")
    try:
        result = run(cell, args.seconds, bool(args.trace), lambda: time.perf_counter() - t_start)
    finally:
        shutil.rmtree(cell.tmpdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    _print_checks(result)
    print(json.dumps(result))
    return 0
