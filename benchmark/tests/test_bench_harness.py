"""The harness is driven by data: a cell, a traffic mix and a metric added as
files (and entries in BENCHMARK.json) are found by name with no harness file
edited; BENCHMARK.json keeps to the contract's names and structure; the
command refuses to run without a card."""

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_a_new_cell_and_metric_are_found_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    mix = json.loads((ROOT / "benchmark" / "traffic" / "walk_4AA.json").read_text())
    mix.update(sequences=4, steps=64)
    (root / "benchmark" / "traffic" / "walk_4AA_short.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "sep_walk_4AA_short.json").write_text(json.dumps({"walk_gap": 1.0}))
    (root / "benchmark" / "metrics" / "frames_per_batch.walk.py").write_text(
        "def read(r):\n    return r.get('frames')\n")
    spec["workloads"].append({"name": "sep_walk_4AA_short", "config": "e3conv_separable",
                              "traffic": "walk_4AA_short", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "frames_per_batch.walk", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "sampler", "moves": "walk_ms_per_sample",
                              "workloads": ["sep_walk_4AA_short"]})
    spec["end_to_end"][0]["workloads"].append("sep_walk_4AA_short")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell(root, "sep_walk_4AA_short", 5)
    assert cell.mix["steps"] == 64 and cell.mix["sequences"] == 4 and cell.limits == {"walk_gap": 1.0}
    assert cell.config["arch"]["tensor_product"] == "uvu"
    assert [m["name"] for m in cell.per_layer] == ["frames_per_batch.walk"]
    assert {m["name"] for m in cell.end_to_end} == {"walk_ms_per_sample", "setup_s"}
    assert harness.metric_reader(root, "frames_per_batch.walk")({"frames": 7}) == 7
    assert type(harness.driver_for(cell)).__name__ == "Driver"
    for name in ("harness.py", "run.py", "traffic/walk.py", "traffic/train.py", "devtrace.py", "weights.py"):
        assert _digest(root / "benchmark" / name) == _digest(ROOT / "benchmark" / name)


def test_names_and_units_keep_to_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in SPEC["end_to_end"] + SPEC["per_layer"])
    texts = [c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
    texts += [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]] + SPEC["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and set(c) == {"name", "source", "file", "reduced", "why"}
    for name, w in cells.items():
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{name}.json").is_file()
        reported = [m for m in SPEC["end_to_end"] if name in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(name in m["workloads"] for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        moves = e2e[m["moves"]]
        assert all(w in moves.get("workloads", cells) for w in m["workloads"]), m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for p in SPEC["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for root in (ROOT, tmp_path):
        if root == tmp_path:  # a directory with only BENCHMARK.json and the benchmark
            shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "sep_walk_4AA", "--seed", "3", "--seconds", "1"],
            cwd=root, capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0
        assert not out.stdout.strip().endswith("}")


def test_modules_of_jax_are_named_whole(monkeypatch):
    assert "jamun_tpu" not in harness.forbidden_modules() or "jamun_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jamun_tpu_torch_lookalike", sys)
    assert "jamun_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_the_trace_reader_takes_the_union_and_the_innermost_operator():
    """Busy time is the union of the device's intervals (two streams at once
    count once); each idle gap goes to the shortest host operator running at
    its midpoint, the first listed among equals."""
    from benchmark.devtrace import Slice

    device = [{"name": "a", "ts": 10.0, "dur": 10.0, "cat": "kernel"},
              {"name": "b", "ts": 15.0, "dur": 10.0, "cat": "kernel"},
              {"name": "c", "ts": 40.0, "dur": 10.0, "cat": "gpu_memcpy"}]
    host = [{"name": "outer", "ts": 0.0, "dur": 100.0, "cat": "cpu_op"},
            {"name": "inner", "ts": 26.0, "dur": 10.0, "cat": "cpu_op"},
            {"name": "twin", "ts": 28.0, "dur": 10.0, "cat": "cpu_op"}]
    s = Slice(device=device, host=host, start=0.0, end=70.0, steps=1)
    assert s.busy_intervals() == [(10.0, 25.0), (40.0, 50.0)]
    assert s.busy_s == pytest.approx(25e-6)
    gaps = dict(s.idle_gaps())
    assert gaps["outer"] == pytest.approx(30e-6)  # [0, 10) and [50, 70)
    assert gaps["inner"] == pytest.approx(15e-6) and "twin" not in gaps  # [25, 40), midpoint 32.5
    s.host = host[:1]
    assert dict(s.idle_gaps()) == pytest.approx({"outer": 45e-6})
    s.host = []
    assert dict(s.idle_gaps()) == pytest.approx({"host outside an operator": 45e-6})
