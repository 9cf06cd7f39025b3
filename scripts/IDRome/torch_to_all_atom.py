"""Convert IDRome coarse-grained (1 bead/residue) samples to all-atom PDBs.

The copy of `scripts/IDRome/to_all_atom.py` on the port's
`jamun_tpu_torch.data`, with no JAX import: the same flags and the same
output bytes. It reconstructs an idealized backbone from CA positions with
the NeRF peptide builder, each built residue moved rigidly onto its bead.

Usage:
    python scripts/IDRome/torch_to_all_atom.py --cg-pdb sample.pdb --sequence SEQ --out aa.pdb
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from jamun_tpu_torch.data.peptide_builder import build_peptide
from jamun_tpu_torch.data.topology import load_pdb, save_pdb


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cg-pdb", required=True, help="CA-trace PDB")
    parser.add_argument("--sequence", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()

    cg_top, cg_pos = load_pdb(args.cg_pdb)
    top, pos = build_peptide(args.sequence)
    # anchor each residue's atoms at the CG bead: rigid-translate the built
    # residue so its CA coincides with the bead
    ca_built = {a.residue_index: i for i, a in enumerate(top.atoms) if a.name == "CA"}
    beads = cg_pos[0]
    out_pos = pos.copy()
    for r, ca_i in ca_built.items():
        if r < len(beads):
            shift = beads[r] - pos[ca_i]
            idx = [a.index for a in top.atoms if a.residue_index == r]
            out_pos[idx] += shift
    save_pdb(args.out, top, out_pos[None])
    print(f"wrote {args.out}: {top.n_atoms} atoms (idealized local geometry; "
          "relax with scripts/generate_data/run_simulation.py if OpenMM is available)")


if __name__ == "__main__":
    main()
