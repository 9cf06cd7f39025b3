"""Build capped/uncapped peptide PDBs from sequences.

The copy of `scripts/prepare_pdb.py` on the port's `jamun_tpu_torch.data`,
with no JAX import: the same flags and the same output bytes (NeRF
internal-coordinate construction, `jamun_tpu_torch/data/peptide_builder.py`).

Usage:
    python scripts/torch_prepare_pdb.py AG SVL --capped --out pdbs/
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from jamun_tpu_torch.data.peptide_builder import build_peptide
from jamun_tpu_torch.data.topology import save_pdb


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("sequences", nargs="+", help="one-letter (AG) or ALA_GLY style")
    parser.add_argument("--capped", action="store_true", help="add ACE/NME caps")
    parser.add_argument("--out", default="pdbs")
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for seq in args.sequences:
        top, pos = build_peptide(seq, capped=args.capped)
        path = os.path.join(args.out, f"{seq}.pdb")
        save_pdb(path, top, pos)
        print(f"wrote {path}: {top.n_atoms} heavy atoms, {len(top.bonds)} bonds")


if __name__ == "__main__":
    main()
