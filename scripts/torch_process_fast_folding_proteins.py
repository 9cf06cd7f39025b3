"""Prepare fast-folding protein trajectories (e.g. chignolin) for training.

The copy of `scripts/process_fast_folding_proteins.py` on the port's
`jamun_tpu_torch.data`, with no JAX import: the same flags and the same
output bytes. Input: a directory of trajectory files (.dcd/.xtc/.npz) and
one topology PDB. Output: chunked train/val layout under --out.

Usage:
    python scripts/torch_process_fast_folding_proteins.py --src trajs/ --pdb top.pdb --out data/ff
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from jamun_tpu_torch.data.datasets import _load_traj_positions
from jamun_tpu_torch.data.dcd import write_dcd
from jamun_tpu_torch.data.topology import load_pdb, save_pdb


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True)
    parser.add_argument("--pdb", required=True, help="topology pdb")
    parser.add_argument("--name", default="chignolin")
    parser.add_argument("--out", required=True)
    parser.add_argument("--val-fraction", type=float, default=0.1)
    parser.add_argument("--chunk", type=int, default=10000)
    args = parser.parse_args()

    files = sorted(
        glob.glob(os.path.join(args.src, "*.dcd"))
        + glob.glob(os.path.join(args.src, "*.xtc"))
        + glob.glob(os.path.join(args.src, "*.npz"))
    )
    top, pos0 = load_pdb(args.pdb)
    all_xyz = np.concatenate([_load_traj_positions(f) for f in files], axis=0)
    n_val = int(len(all_xyz) * args.val_fraction)
    splits = {"val": all_xyz[:n_val], "train": all_xyz[n_val:]}
    for split, xyz in splits.items():
        d = os.path.join(args.out, split)
        os.makedirs(d, exist_ok=True)
        for i in range(0, len(xyz), args.chunk):
            write_dcd(os.path.join(d, f"{args.name}_part{i // args.chunk:03d}.dcd"), xyz[i : i + args.chunk])
        save_pdb(os.path.join(d, f"{args.name}.pdb"), top, pos0[:1])
        print(f"{split}: {xyz.shape}")


if __name__ == "__main__":
    main()
