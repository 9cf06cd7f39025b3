"""The program's spans in a profiled slice (`benchmark/spans.py`), on small
hand-written Chrome traces: the slice's existing fields and methods read
what `devtrace` reads from the same trace, the spans, the launches by
correlation id (a kernel launched on a second thread inside
`jamun.train.backward`), the idle gaps by span and the seven readers of
`benchmark/span_metrics.json`, which find nothing in a trace without the
program's spans."""

import json

import pytest
import torch

from benchmark import devtrace, harness, spans
from benchmark.tests.conftest import ROOT


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def _annotation():
    return _x("bench_slice", "user_annotation", 0.0, 1000.0)


# a walk: two steps (the first forward on the stack path), the batch's
# synchronisation, the unbatching; four idle gaps with midpoints 50, 325, 625, 950
WALK_DEVICE = [
    _x("k_a", "kernel", 100.0, 100.0, tid=7, correlation=1),
    _x("k_b", "kernel", 150.0, 100.0, tid=7, correlation=2),
    _x("Memcpy DtoH", "gpu_memcpy", 400.0, 50.0, tid=7, correlation=3),
    _x("k_c", "kernel", 800.0, 100.0, tid=7, correlation=4),
]
WALK_HOST = [
    _x("aten::mm", "cpu_op", 40.0, 80.0),
    _x("aten::copy_", "cpu_op", 300.0, 200.0),
    _x("aten::cat", "cpu_op", 940.0, 20.0),
    _x("cudaLaunchKernel", "cuda_runtime", 35.0, 5.0, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 45.0, 5.0, correlation=2),
    _x("cudaMemcpyAsync", "cuda_runtime", 330.0, 100.0, correlation=3),
    _x("cudaLaunchKernel", "cuda_runtime", 640.0, 5.0, correlation=4),
]
WALK_SPANS = [
    _x("jamun.sample.batch", "user_annotation", 5.0, 990.0),
    _x("jamun.walk.step", "user_annotation", 10.0, 290.0),
    _x("jamun.denoiser.score", "user_annotation", 20.0, 200.0),
    _x("jamun.denoiser.xhat", "user_annotation", 25.0, 190.0),
    _x("jamun.e3conv.forward:stack", "user_annotation", 30.0, 100.0),
    _x("jamun.walk.step", "user_annotation", 300.0, 300.0),
    _x("jamun.denoiser.score", "user_annotation", 310.0, 240.0),
    _x("jamun.denoiser.xhat", "user_annotation", 320.0, 220.0),
    _x("jamun.host.wait:batch_sync", "user_annotation", 600.0, 100.0),
    _x("jamun.sample.unbatch", "user_annotation", 900.0, 90.0),
    _x("jamun.host.wait:unbatch_copy", "user_annotation", 905.0, 30.0),
    _x("Optimizer.step#Adam.step", "user_annotation", 700.0, 10.0),  # torch's own: not a program span
]
WALK = [_annotation()] + WALK_DEVICE + WALK_HOST + WALK_SPANS

# a training step: the backward's kernels launched on autograd's device
# thread (tid 2), a kernel whose launch the trace lacks
TRAIN = [_annotation()] + [
    _x("jamun.train.step", "user_annotation", 0.0, 960.0),
    _x("jamun.train.to_device", "user_annotation", 5.0, 45.0),
    _x("jamun.train.forward", "user_annotation", 50.0, 250.0),
    _x("jamun.train.backward", "user_annotation", 300.0, 400.0),
    _x("jamun.train.grad_norm", "user_annotation", 700.0, 50.0),
    _x("jamun.train.optimizer", "user_annotation", 750.0, 100.0),
    _x("jamun.train.ema", "user_annotation", 850.0, 50.0),
    _x("cudaMemcpyAsync", "cuda_runtime", 20.0, 5.0, correlation=10),
    _x("cudaLaunchKernel", "cuda_runtime", 100.0, 5.0, correlation=11),
    _x("cudaLaunchKernel", "cuda_runtime", 350.0, 5.0, tid=2, correlation=12),
    _x("cudaLaunchKernel", "cuda_runtime", 500.0, 5.0, tid=2, correlation=13),
    _x("cudaLaunchKernel", "cuda_runtime", 710.0, 5.0, correlation=14),
    _x("cuLaunchKernel", "cuda_driver", 760.0, 5.0, correlation=15),
    _x("cudaLaunchKernel", "cuda_runtime", 860.0, 5.0, correlation=16),
    _x("Memcpy HtoD", "gpu_memcpy", 30.0, 20.0, tid=7, correlation=10),
    _x("fwd", "kernel", 110.0, 150.0, tid=7, correlation=11),
    _x("bwd", "kernel", 360.0, 300.0, tid=7, correlation=12),
    _x("bwd", "kernel", 660.0, 60.0, tid=7, correlation=13),
    _x("norm", "kernel", 720.0, 20.0, tid=7, correlation=14),
    _x("adam", "kernel", 770.0, 50.0, tid=7, correlation=15),
    _x("ema", "kernel", 870.0, 10.0, tid=7, correlation=16),
    _x("unknown", "kernel", 950.0, 10.0, tid=7, correlation=99),
]

WALK_METRICS = ("walk_step_host_ms.walk", "score_span_ms.walk", "idle_in_forward_share.walk",
                "host_wait_share.walk")
TRAIN_METRICS = ("forward_device_ms.train", "backward_device_ms.train", "optimizer_device_ms.train")


class _FakeProfile:
    """`torch.profiler.profile` that writes a fixed trace."""

    def __init__(self, events):
        self.events = events

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


@pytest.fixture
def profiled(monkeypatch):
    """profiled(profile_slice, events, steps): that function's slice of a
    trace holding `events`."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def run(profile_slice, events, steps):
        monkeypatch.setattr(torch.profiler, "profile", lambda activities: _FakeProfile(events))
        return profile_slice(lambda: None, steps)

    return run


def _rows(got, want):
    """Rows of a breakdown: the names (and counts) exactly, the seconds approximately."""
    assert [[x for x in row if not isinstance(x, float)] for row in got] == \
        [[x for x in row if not isinstance(x, float)] for row in want]
    assert [x for row in got for x in row if isinstance(x, float)] == \
        pytest.approx([x for row in want for x in row if isinstance(x, float)])


def _read(name, kind, s):
    return harness.metric_reader(ROOT, name)({"kind": kind, "slice": s})


def test_existing_fields_read_as_before(profiled):
    """`devtrace`'s slice of the walk trace, its fields and methods written
    out; the span slice of the same trace reads each of them alike."""
    old = profiled(devtrace.profile_slice, WALK, 2)
    assert (old.start, old.end, old.steps) == (0.0, 1000.0, 2)
    assert [(e["name"], e["ts"], e["dur"], e["cat"]) for e in old.device] == [
        ("k_a", 100.0, 100.0, "kernel"), ("k_b", 150.0, 100.0, "kernel"),
        ("Memcpy DtoH", 400.0, 50.0, "gpu_memcpy"), ("k_c", 800.0, 100.0, "kernel")]
    assert [e["name"] for e in old.host] == ["aten::mm", "aten::copy_", "aten::cat"]
    assert old.busy_intervals() == [(100.0, 250.0), (400.0, 450.0), (800.0, 900.0)]
    assert old.busy_s == pytest.approx(3e-4) and old.wall_s == pytest.approx(1e-3)
    assert old.kernel_s(lambda n: n.startswith("k_")) == pytest.approx(3e-4)
    _rows(old.top_device_ops(), [["k_a", 1e-4], ["k_b", 1e-4], ["k_c", 1e-4], ["Memcpy DtoH", 5e-5]])
    _rows(old.idle_gaps(), [["host outside an operator", 3.5e-4], ["aten::copy_", 1.5e-4],
                            ["aten::mm", 1e-4], ["aten::cat", 1e-4]])
    new = profiled(spans.profile_slice, WALK, 2)
    assert isinstance(new, devtrace.Slice)
    assert (new.start, new.end, new.steps) == (old.start, old.end, old.steps)
    assert [{k: v for k, v in e.items() if k != "correlation"} for e in new.device] == old.device
    assert new.host == old.host
    assert new.busy_intervals() == old.busy_intervals() and new.busy_s == old.busy_s
    assert new.kernel_s(lambda n: n.startswith("k_")) == old.kernel_s(lambda n: n.startswith("k_"))
    assert new.top_device_ops() == old.top_device_ops() and new.idle_gaps() == old.idle_gaps()


def test_spans_launches_and_idle_gaps_by_span(profiled):
    s = profiled(spans.profile_slice, WALK, 2)
    assert [(x["name"], x["ts"], x["dur"], x["tid"]) for x in s.spans[:3]] == [
        ("jamun.sample.batch", 5.0, 990.0, 1), ("jamun.walk.step", 10.0, 290.0, 1),
        ("jamun.denoiser.score", 20.0, 200.0, 1)]
    assert len(s.spans) == 11  # torch's `Optimizer.step#...` is left out
    assert s.launches == {1: 35.0, 2: 45.0, 3: 330.0, 4: 640.0}
    assert [e["correlation"] for e in s.device] == [1, 2, 3, 4]
    assert s.span_s("jamun.walk.step") == pytest.approx([2.9e-4, 3e-4])
    _rows(s.idle_gaps_by_span(), [
        ["jamun.host.wait:batch_sync", 3.5e-4], ["jamun.denoiser.xhat", 1.5e-4],
        ["jamun.e3conv.forward:stack", 1e-4], ["jamun.sample.unbatch", 1e-4]])
    assert s.idle_in("jamun.denoiser.xhat") == pytest.approx(2.5e-4)  # midpoints 50 and 325
    assert s.wall_in("jamun.host.wait:*") == pytest.approx(1.3e-4)
    # the steps launched k_a, k_b and the copy, the batch's wait k_c
    assert s.device_s_in("jamun.walk.step") == pytest.approx(2.5e-4)
    assert s.device_s_in("jamun.host.wait:*") == pytest.approx(1e-4)
    _rows(s.span_totals()[:1], [["jamun.sample.batch", 1, 9.9e-4, 3.5e-4]])

    t = profiled(spans.profile_slice, TRAIN, 1)
    assert t.launches[12] == 350.0 and t.launches[15] == 760.0  # a CUDA driver API call launches too
    assert t.device_s_in("jamun.train.backward") == pytest.approx(3.6e-4)  # launched on thread 2
    assert t.device_s_in("jamun.train.to_device") == pytest.approx(2e-5)
    assert t.device_s_in("jamun.train.step") == pytest.approx(6.1e-4)  # `unknown` has no launch
    _rows(t.idle_gaps_by_span(), [
        ["jamun.train.backward", 1e-4], ["jamun.train.optimizer", 8e-5], ["jamun.train.step", 7e-5],
        ["jamun.train.forward", 6e-5], [spans.OUTSIDE, 4e-5], ["jamun.train.to_device", 3e-5]])


def test_the_readers(profiled):
    walk, train = profiled(spans.profile_slice, WALK, 2), profiled(spans.profile_slice, TRAIN, 1)
    got = {m: _read(m, "walk", walk) for m in WALK_METRICS}
    assert got == pytest.approx({
        "walk_step_host_ms.walk": 0.295,  # (290 + 300) / 2 us
        "score_span_ms.walk": 0.22,
        "idle_in_forward_share.walk": 100.0 * 250.0 / 700.0,
        "host_wait_share.walk": 13.0,  # 100 + 30 us of 1000
    })
    got = {m: _read(m, "train", train) for m in TRAIN_METRICS}
    assert got == pytest.approx({"forward_device_ms.train": 0.15, "backward_device_ms.train": 0.36,
                                 "optimizer_device_ms.train": 0.08})
    for m in WALK_METRICS:
        assert _read(m, "train", train) is None
    for m in TRAIN_METRICS:
        assert _read(m, "walk", walk) is None


def test_the_readers_find_nothing_without_program_spans(profiled):
    """The parent's trace: no `jamun.` span. The readers give nothing, from
    the span slice and from `devtrace`'s slice alike, and the idle time is
    all outside a program span."""
    bare = [e for e in WALK if not e["name"].startswith("jamun.")]
    bare_train = [e for e in TRAIN if not e["name"].startswith("jamun.")]
    for profile_slice in (spans.profile_slice, devtrace.profile_slice):
        walk, train = profiled(profile_slice, bare, 2), profiled(profile_slice, bare_train, 1)
        assert all(_read(m, "walk", walk) is None for m in WALK_METRICS)
        assert all(_read(m, "train", train) is None for m in TRAIN_METRICS)
    _rows(profiled(spans.profile_slice, bare, 2).idle_gaps_by_span(), [[spans.OUTSIDE, 7e-4]])


def test_span_metrics_keep_to_the_contract():
    """The entries `spanrun.py` adds, in BENCHMARK.json's form: names, units,
    layers and the end-to-end metrics they move as the accepted entries
    have them, a reader each, cells that report what they move."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = json.loads((ROOT / "benchmark" / "span_metrics.json").read_text())
    assert [m["name"] for m in entries] == list(WALK_METRICS + TRAIN_METRICS)
    layers = {m["layer"] for m in spec["per_layer"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    taken = {m["name"] for m in spec["per_layer"] + spec["end_to_end"]}
    for m in entries:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] not in taken and m["source"] == "device_trace" and m["better"] == "lower"
        assert m["layer"] in layers and set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"]) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("workload, events, metrics, steps", [
    ("sep_walk_4AA", WALK, WALK_METRICS, 1), ("uvw_train_4AA", TRAIN, TRAIN_METRICS, 5)])
def test_spanrun_adds_the_span_readings_to_a_traced_run(cell_factory, profiled, workload, events, metrics, steps):
    """`spanrun.run` around `harness.run` on a small cell on the CPU, the
    profiler's trace replaced by a fixture (the cell's own work runs): the
    result holds the cell's span metrics and both breakdowns, and
    `devtrace.profile_slice` is put back."""
    from benchmark import spanrun

    plain = devtrace.profile_slice
    profiled(lambda fn, steps: None, events, 1)  # the fixture's trace from here on
    out = spanrun.run(cell_factory(workload), 0.2, False, lambda: 0.0, harness.run)
    assert devtrace.profile_slice is plain
    assert out["correct"], out["checks"]
    assert set(metrics) <= set(out["metrics"])
    if workload == "uvw_train_4AA":
            assert out["metrics"]["backward_device_ms.train"]["value"] == pytest.approx(0.36 / steps)
    names = [row[0] for row in out["breakdown"]["idle_gaps_by_span"]]
    assert names and all(n.startswith("jamun.") or n == spans.OUTSIDE for n in names)
    assert out["breakdown"]["span_totals"][0][0] in ("jamun.sample.batch", "jamun.train.step")
    assert {"device_ops", "idle_gaps"} <= set(out["breakdown"])
