"""Split long trajectories into fixed-size chunk files.

The copy of `scripts/chunk_trajectory.py` on the port's
`jamun_tpu_torch.data`, with no JAX import: the same flags and the same
output bytes.

Usage:
    python scripts/torch_chunk_trajectory.py traj.dcd --chunk 1000 --out chunks/
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from jamun_tpu_torch.data.datasets import _load_traj_positions
from jamun_tpu_torch.data.dcd import write_dcd


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("trajfile")
    parser.add_argument("--chunk", type=int, default=1000)
    parser.add_argument("--out", default="chunks")
    parser.add_argument("--format", default="dcd", choices=["dcd", "npz", "npy"])
    args = parser.parse_args()

    xyz = _load_traj_positions(args.trajfile)
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.trajfile))[0]
    n_chunks = (len(xyz) + args.chunk - 1) // args.chunk
    for i in range(n_chunks):
        part = xyz[i * args.chunk : (i + 1) * args.chunk]
        path = os.path.join(args.out, f"{stem}_chunk{i:04d}.{args.format}")
        if args.format == "dcd":
            write_dcd(path, part)
        elif args.format == "npz":
            np.savez_compressed(path, positions=part)
        else:
            np.save(path, part)
        print(f"wrote {path}: {part.shape}")


if __name__ == "__main__":
    main()
