"""Batch analysis over every label of a sampling run (counterpart of
`jamun_tpu/analysis/analysis_sweep.py`): a local loop of
`analyze_trajectories`, each label's sample against its reference
trajectory `<reference-dir>/<label><suffix>` (`.xtc`, `.dcd`, `.npz`, `.npy`
or `.pdb`, through the datasets' loader; a trajectory of the full topology
is cut to its heavy atoms).

    python -m jamun_tpu_torch.analysis.analysis_sweep --run-dir runs/sample_uncapped_2AA \
        --reference-dir $JAMUN_DATA_PATH/timewarp/2AA-1-large/test --out analysis_out

IDRome's layout (one directory per protein):
`--ref-traj-suffix /traj.xtc --ref-pdb-suffix /top.pdb`. Writes
`<out>/<label>.json` and `<out>/summary.json`; as in JAX, a label whose
analysis raises gets `{"error": ...}` in the summary and the loop goes on.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from jamun_tpu_torch.analysis.load_trajectory import list_run_labels, load_run_trajectory
from jamun_tpu_torch.analysis.run_analysis import analyze_trajectories
from jamun_tpu_torch.data.datasets import _load_traj_positions
from jamun_tpu_torch.data.topology import load_pdb

log = logging.getLogger("jamun_tpu_torch")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--reference-dir", required=True)
    parser.add_argument("--ref-traj-suffix", default="-traj-arrays.npz")
    parser.add_argument("--ref-pdb-suffix", default="-traj-state0.pdb")
    parser.add_argument("--out", default="analysis_out")
    parser.add_argument("--tica-lag", type=int, default=1000)
    parser.add_argument("--labels", nargs="*", default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    labels = args.labels or list_run_labels(args.run_dir)
    os.makedirs(args.out, exist_ok=True)
    summary = {}
    for label in labels:
        try:
            top, pred = load_run_trajectory(args.run_dir, label)
            ref_pdb = os.path.join(args.reference_dir, label + args.ref_pdb_suffix)
            ref_traj = os.path.join(args.reference_dir, label + args.ref_traj_suffix)
            full_top, _ = load_pdb(ref_pdb)
            ref = _load_traj_positions(ref_traj)
            heavy = np.asarray(full_top.select_protein_heavy())
            if ref.shape[1] == full_top.n_atoms:
                ref = ref[:, heavy]
            result = analyze_trajectories(top, pred, ref, tica_lag=args.tica_lag)
            scalar = {k: v for k, v in result.items() if isinstance(v, (int, float))}
            summary[label] = scalar
            with open(os.path.join(args.out, f"{label}.json"), "w") as f:
                json.dump(scalar, f, indent=2, default=float)
            log.info("%s: %s", label, scalar)
        except Exception as e:
            log.warning("analysis failed for %s: %s", label, e)
            summary[label] = {"error": str(e)}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    log.info("wrote %s/summary.json (%d peptides)", args.out, len(summary))


if __name__ == "__main__":
    main()
