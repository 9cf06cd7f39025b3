"""Seeded peptide batches: sequences and backbone dihedrals drawn from a seed,
built and padded to one bucket as the port's `collate` pads them.

A batch is a dict of numpy arrays with a leading graph axis, under the field
names of the port's `GraphBatch` (without the residue layout, which E3Conv
does not read). The same arrays go to the program (as a `GraphBatch`) and to
the reference. Everything here is a function of the seed and the mix's
parameters alone.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from benchmark.inputs.peptides import AA_3CODES, build_peptide, featurize, heavy_atom_count

__all__ = ["draw_sequence", "draw_dihedrals", "pad_batch", "walk_batch", "train_pool", "BASINS"]

_ALPHABET = sorted(AA_3CODES)
# (phi, psi) centres of the backbone basins (degrees) and their weights:
# right-handed helix, beta strand, polyproline II
BASINS = {"alpha": (-63.0, -43.0), "beta": (-120.0, 130.0), "ppii": (-75.0, 145.0)}
_BASIN_WEIGHTS = {"alpha": 0.3, "beta": 0.4, "ppii": 0.3}


def draw_sequence(rng: np.random.Generator, lengths: Sequence[int], max_atoms: int) -> str:
    """A sequence of one of `lengths` residues, uniform over the 20 amino
    acids, with at most `max_atoms` heavy atoms (drawn again until it fits)."""
    while True:
        n = int(rng.choice(lengths))
        seq = "".join(rng.choice(_ALPHABET, size=n))
        if heavy_atom_count(seq) <= max_atoms:
            return seq


def draw_dihedrals(rng: np.random.Generator, n: int, basins: Sequence[str], jitter: float):
    """phi, psi per residue: each residue's basin drawn from `basins` (by
    their weights), then a Gaussian jitter of `jitter` degrees."""
    names = list(basins)
    w = np.asarray([_BASIN_WEIGHTS[b] for b in names])
    pick = rng.choice(len(names), size=n, p=w / w.sum())
    centre = np.asarray([BASINS[names[k]] for k in pick])
    angles = centre + jitter * rng.standard_normal((n, 2))
    return angles[:, 0].tolist(), angles[:, 1].tolist()


def molecule(rng: np.random.Generator, params: dict) -> dict:
    seq = draw_sequence(rng, params["residues"], params["max_atoms"])
    phi, psi = draw_dihedrals(rng, len(seq), params["basins"], params["jitter_deg"])
    return featurize(*build_peptide(seq, phi, psi))


def pad_batch(mols: List[dict], n_pad: int, bond_multiplier: float = 2.2) -> Dict[str, np.ndarray]:
    """Stack molecules into [G, ...] arrays padded to `n_pad` atoms and the
    bond bucket `int(bond_multiplier * n_pad)` (or the most bonds of a
    molecule, if more), as the port's `collate` pads them. Each molecule is
    centred at the origin: the denoiser centres its output, so the score of
    a molecule away from the origin carries the way back, which the walk's
    per-atom clip turns into a deformation of the structure."""
    G = len(mols)
    b_pad = max(max(len(m["bond_src"]) for m in mols), int(bond_multiplier * n_pad))
    out = dict(
        pos=np.zeros((G, n_pad, 3), np.float32),
        node_mask=np.zeros((G, n_pad), bool),
        bond_src=np.zeros((G, b_pad), np.int64),
        bond_dst=np.zeros((G, b_pad), np.int64),
        bond_mask=np.zeros((G, b_pad), bool),
        loss_weight=np.ones((G,), np.float32),
        graph_mask=np.ones((G,), bool),
    )
    for key in ("atom_type_index", "atom_code_index", "residue_code_index", "residue_sequence_index"):
        out[key] = np.zeros((G, n_pad), np.int64)
    for g, m in enumerate(mols):
        n, nb = len(m["pos"]), len(m["bond_src"])
        if n > n_pad:
            raise ValueError(f"{n} atoms do not fit the bucket of {n_pad}")
        out["pos"][g, :n] = m["pos"] - m["pos"].mean(0)
        out["node_mask"][g, :n] = True
        for key in ("atom_type_index", "atom_code_index", "residue_code_index", "residue_sequence_index"):
            out[key][g, :n] = m[key]
        out["bond_src"][g, :nb] = m["bond_src"]
        out["bond_dst"][g, :nb] = m["bond_dst"]
        out["bond_mask"][g, :nb] = True
    return out


def walk_batch(seed: int, params: dict) -> Dict[str, np.ndarray]:
    """The walk's initial graphs: `sequences` molecules, each repeated
    `chains_per_sequence` times (the sample CLI's layout: every chain of a
    peptide starts from its structure). The molecules are drawn from the
    mix's `structure_seed`, so that every run does the same work (the pairs
    inside the cutoff set the kernels' time); the run's seed orders them."""
    rng = np.random.default_rng([params["structure_seed"], 1])
    mols = [molecule(rng, params) for _ in range(params["sequences"])]
    order = np.random.default_rng([seed, 1]).permutation(len(mols))
    chains = [mols[i] for i in order for _ in range(params["chains_per_sequence"])]
    return pad_batch(chains, params["bucket"])


def train_pool(seed: int, params: dict) -> List[Dict[str, np.ndarray]]:
    """`pool_batches` training batches of `batch_size` molecules each, every
    molecule drawn anew from the seed (no two rows alike)."""
    rng = np.random.default_rng([seed, 2])
    return [
        pad_batch([molecule(rng, params) for _ in range(params["batch_size"])], params["bucket"])
        for _ in range(params["pool_batches"])
    ]
