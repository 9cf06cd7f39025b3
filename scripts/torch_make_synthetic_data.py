"""Generate a synthetic peptide-like dataset in the Timewarp layout
(<code>-traj-arrays.npz / <code>-traj-state0.pdb) for smoke tests and CI.

The copy of `scripts/make_synthetic_data.py` on the port's
`jamun_tpu_torch.data`, with no JAX import: the same flags and the same
output bytes, so it runs on a machine that has PyTorch alone.

The "molecule" is a heavy-atom backbone chain (N-CA-C-O per residue) breathing
around a helix-like curve — chemically fake but geometrically peptide-scale,
which is all the training/sampling machinery needs.

Usage:
    python scripts/torch_make_synthetic_data.py --out data/synthetic/train
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from jamun_tpu_torch.data.topology import Atom, Topology, save_pdb


def make_molecule(n_residues: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    names = ["N", "CA", "C", "O"]
    elements = ["N", "C", "C", "O"]
    residues = ["ALA", "GLY", "SER", "VAL", "LEU"]
    atoms, pos = [], []
    for r in range(n_residues):
        res = residues[r % len(residues)]
        for i, (nm, el) in enumerate(zip(names, elements)):
            t = len(pos) * 0.5
            # helix-ish backbone, 0.14 nm spacing
            base = np.array([0.10 * len(pos), 0.12 * np.sin(t), 0.12 * np.cos(t)])
            atoms.append(
                Atom(
                    index=len(atoms),
                    name=nm,
                    element=el,
                    residue_name=res,
                    residue_index=r,
                    residue_seq=r + 1,
                )
            )
            pos.append(base)
    return Topology(atoms=atoms, bonds=[]), np.asarray(pos, np.float32)


def make_trajectory(pos0: np.ndarray, n_frames: int, seed: int = 0, amp: float = 0.02):
    rng = np.random.default_rng(seed)
    n = len(pos0)
    # two breathing modes + small noise
    m1 = rng.standard_normal((n, 3)) * amp
    m2 = rng.standard_normal((n, 3)) * amp
    t = np.linspace(0, 20 * np.pi, n_frames)[:, None, None]
    traj = (
        pos0[None]
        + np.sin(t) * m1[None]
        + np.cos(0.37 * t) * m2[None]
        + rng.standard_normal((n_frames, n, 3)) * 0.003
    )
    return traj.astype(np.float32)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="data/synthetic/train")
    parser.add_argument("--codes", nargs="*", default=["AG", "SV"])
    parser.add_argument("--n-frames", type=int, default=500)
    parser.add_argument("--n-residues", type=int, default=2)
    args = parser.parse_args()

    os.makedirs(args.out, exist_ok=True)
    for i, code in enumerate(args.codes):
        top, pos0 = make_molecule(args.n_residues, seed=i)
        traj = make_trajectory(pos0, args.n_frames, seed=100 + i)
        save_pdb(os.path.join(args.out, f"{code}-traj-state0.pdb"), top, pos0)
        np.savez(os.path.join(args.out, f"{code}-traj-arrays.npz"), positions=traj)
        print(f"wrote {code}: {traj.shape} -> {args.out}")


if __name__ == "__main__":
    main()
