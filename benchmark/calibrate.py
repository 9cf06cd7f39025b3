"""The readings the check's limits are set from, for one cell, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds <n> --controls <n> [--faults]

For each of `--seeds` seeds (drawn from `--first`), the cell's set-up and a
short window of `--seconds` (one batch or one step past the set-up's), then
the check's numbers: the program's readings (the lower ones). For the first
`--controls` of those seeds, the check's numbers with the reference in the
configuration's control precision in the program's place (the upper ones);
with `--faults`, also with a training cell's faults planted in the reference
put in the program's place. Each line says whether its numbers pass the
committed limits (`harness.judge`, as a run judges), and the command exits
with 1 where a control's or a fault's do. One JSON line per reading on
standard output, and the same lines in
`chiprun_out/calibrate_<workload>.jsonl`. The benchmark's own runs do not
run this.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference.precision import Precision, reference_matmul_policy  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    root = Path(ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from jamun_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    os.makedirs(root / "chiprun_out", exist_ok=True)
    log = open(root / "chiprun_out" / f"calibrate_{args.workload}.jsonl", "a")

    def emit(**row):
        row["t"] = time.perf_counter() - T0
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    emit(card=torch.cuda.get_device_name(0), workload=args.workload)
    passed = []  # whether each control's and fault's readings pass the committed limits
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        cell = harness.find_cell(root, args.workload, seed)
        # a short window of one batch: draw from it as many chains as a run checks
        cell.mix["check_per_batch"] = max(cell.mix.get("check_per_batch", 0), cell.mix.get("check_chains", 0))
        cell.device, cell.tmpdir = torch.device("cuda", 0), tempfile.mkdtemp(prefix="bench_calibrate_")
        driver = harness.driver_for(cell)
        reference_matmul_policy()
        driver.setup()
        driver.run(args.seconds, lambda: None, keep_frames=False)
        driver.release()
        gc.collect()
        torch.cuda.empty_cache()
        program = driver.check(detail=True)
        emit(seed=seed, side="program", passes=harness.judge(program, cell.limits), **program)
        if i < args.controls:
            control = driver.check(Precision(cell.config["control"]), detail=True)
            passed.append(harness.judge(control, cell.limits))
            emit(seed=seed, side="control", precision=cell.config["control"], passes=passed[-1], **control)
            if args.faults and driver.kind == "train":
                fault = driver.check(fault="half_batch")
                passed.append(harness.judge(fault, cell.limits))
                emit(seed=seed, side="fault", fault="half_batch", passes=passed[-1], **fault)
        shutil.rmtree(cell.tmpdir, ignore_errors=True)
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    emit(done=True, peak_bytes=torch.cuda.max_memory_allocated(), controls_and_faults_passing=sum(passed))
    if any(passed):
        print("calibrate: a control or a fault passes the committed limits", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
