"""Convert MDGen 4AA trajectory releases into the framework's dataset layout.

The copy of `scripts/process_mdgen.py` on the port's `jamun_tpu_torch.data`,
with no JAX import: the same flags and the same output bytes. Input: a
directory of <peptide>.xtc + <peptide>.pdb pairs (downloaded separately).
Output: <out>/{train,val,test}/<peptide>.{dcd,pdb} split.

Usage:
    python scripts/torch_process_mdgen.py --src mdgen/ --out data/mdgen
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from jamun_tpu_torch.data.datasets import _load_traj_positions
from jamun_tpu_torch.data.dcd import write_dcd
from jamun_tpu_torch.data.topology import load_pdb, save_pdb


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True, help="dir of <pep>.xtc + <pep>.pdb")
    parser.add_argument("--out", required=True)
    parser.add_argument("--val-fraction", type=float, default=0.05)
    parser.add_argument("--test-fraction", type=float, default=0.05)
    parser.add_argument("--subsample", type=int, default=1)
    args = parser.parse_args()

    peptides = sorted(
        os.path.splitext(f)[0] for f in os.listdir(args.src) if f.endswith(".xtc")
    )
    rng = np.random.default_rng(0)
    rng.shuffle(peptides)
    n = len(peptides)
    n_test = max(int(n * args.test_fraction), 1)
    n_val = max(int(n * args.val_fraction), 1)
    splits = {
        "test": peptides[:n_test],
        "val": peptides[n_test : n_test + n_val],
        "train": peptides[n_test + n_val :],
    }
    for split, peps in splits.items():
        os.makedirs(os.path.join(args.out, split), exist_ok=True)
        for pep in peps:
            xyz = _load_traj_positions(os.path.join(args.src, f"{pep}.xtc"))[:: args.subsample]
            top, pos0 = load_pdb(os.path.join(args.src, f"{pep}.pdb"))
            write_dcd(os.path.join(args.out, split, f"{pep}.dcd"), xyz)
            save_pdb(os.path.join(args.out, split, f"{pep}.pdb"), top, pos0[:1])
            print(f"{split}/{pep}: {xyz.shape}")


if __name__ == "__main__":
    main()
