"""The data-preparation scripts' copies on `jamun_tpu_torch.data`
(`scripts/torch_*.py`, `scripts/IDRome/torch_to_all_atom.py`) against the
originals on `jamun_tpu.data` (CPU): each pair runs with the same flags on
the same small inputs, written in the test with the port's `write_dcd`,
`write_xtc` and `save_pdb` (a few frames each), and the two output trees hold
the same files, byte for byte. Both run in this process through `runpy`, as
`python <script> <flags>` would run them. That the copies import no JAX is
`tests/test_torch_ops.py::test_port_imports_no_jax`'s.
"""

import os
import runpy
import sys

import numpy as np
import pytest

from jamun_tpu_torch.data.dcd import write_dcd
from jamun_tpu_torch.data.peptide_builder import build_peptide
from jamun_tpu_torch.data.topology import Atom, Topology, save_pdb
from jamun_tpu_torch.data.xtc import write_xtc

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCRIPTS = os.path.join(REPO, "scripts")


def _run(script: str, argv, monkeypatch, cwd) -> None:
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [script, *argv])
    runpy.run_path(script, run_name="__main__")


def _tree(root) -> dict:
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _same_outputs(name, argv_of, tmp_path, monkeypatch, n_files):
    """Run the original and its copy with `argv_of(out_dir)`; the two output
    trees must hold the same file names and bytes (at least `n_files`)."""
    original = os.path.join(SCRIPTS, *name.split("/"))
    head, base = os.path.split(name)
    copy = os.path.join(SCRIPTS, head, f"torch_{base}")
    trees = []
    for tag, script in (("jax", original), ("torch", copy)):
        out = tmp_path / f"out_{tag}"
        _run(script, argv_of(str(out)), monkeypatch, tmp_path)
        trees.append(_tree(out))
    assert sorted(trees[0]) == sorted(trees[1])
    assert len(trees[0]) >= n_files, sorted(trees[0])
    for rel, data in trees[0].items():
        assert trees[1][rel] == data, rel


def _frames(n_frames, n_atoms, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_atoms, 3)).astype(np.float32)
    return (base[None] + 0.05 * rng.standard_normal((n_frames, n_atoms, 3))).astype(np.float32)


def test_make_synthetic_data(tmp_path, monkeypatch):
    _same_outputs("make_synthetic_data.py",
                  lambda out: ["--out", out, "--codes", "AG", "SVL", "KW", "--n-frames", "7",
                               "--n-residues", "3"], tmp_path, monkeypatch, 6)


@pytest.mark.parametrize("capped", [False, True], ids=["uncapped", "capped"])
def test_prepare_pdb(capped, tmp_path, monkeypatch):
    _same_outputs("prepare_pdb.py",
                  lambda out: ["AG", "SVL", "KWFE", "ALA_GLY", "--out", out] + (["--capped"] if capped else []),
                  tmp_path, monkeypatch, 4)


@pytest.mark.parametrize("fmt", ["dcd", "npz", "npy"])
@pytest.mark.parametrize("src", ["dcd", "xtc"])
def test_chunk_trajectory(src, fmt, tmp_path, monkeypatch):
    xyz = _frames(25, 9, seed=1)
    path = str(tmp_path / f"traj.{src}")
    (write_dcd if src == "dcd" else write_xtc)(path, xyz)
    _same_outputs("chunk_trajectory.py",
                  lambda out: [path, "--chunk", "10", "--out", out, "--format", fmt],
                  tmp_path, monkeypatch, 3)


def test_process_mdgen(tmp_path, monkeypatch):
    src = tmp_path / "mdgen"
    src.mkdir()
    for i, seq in enumerate(("AGKW", "SVLF", "MHQT", "WYRK", "FNEY")):
        top, pos = build_peptide(seq)
        save_pdb(str(src / f"{seq}.pdb"), top, pos)
        frames = pos[None] + 0.02 * np.random.default_rng(i).standard_normal((6,) + pos.shape)
        write_xtc(str(src / f"{seq}.xtc"), frames.astype(np.float32))
    _same_outputs("process_mdgen.py",
                  lambda out: ["--src", str(src), "--out", out, "--val-fraction", "0.2",
                               "--test-fraction", "0.2", "--subsample", "2"], tmp_path, monkeypatch, 10)


def test_process_fast_folding_proteins(tmp_path, monkeypatch):
    src = tmp_path / "trajs"
    src.mkdir()
    top, pos = build_peptide("YYDPETGTWY")
    pdb = str(tmp_path / "chignolin.pdb")
    save_pdb(pdb, top, pos)
    n = pos.shape[0]
    write_dcd(str(src / "a.dcd"), _frames(11, n, seed=2))
    write_xtc(str(src / "b.xtc"), _frames(9, n, seed=3))
    np.savez(str(src / "c.npz"), positions=_frames(7, n, seed=4))
    _same_outputs("process_fast_folding_proteins.py",
                  lambda out: ["--src", str(src), "--pdb", pdb, "--name", "chig", "--out", out,
                               "--val-fraction", "0.25", "--chunk", "8"], tmp_path, monkeypatch, 5)


def test_idrome_to_all_atom(tmp_path, monkeypatch):
    seq = "MSEQKPGRAS"
    rng = np.random.default_rng(5)
    beads = np.cumsum(0.38 * rng.standard_normal((len(seq), 3)), axis=0).astype(np.float32)
    atoms = [Atom(index=i, name="CA", element="C", residue_name="ALA", residue_index=i, residue_seq=i + 1)
             for i in range(len(seq))]
    cg = str(tmp_path / "cg.pdb")
    save_pdb(cg, Topology(atoms=atoms, bonds=[]), beads)
    os.makedirs(tmp_path / "out_jax")
    os.makedirs(tmp_path / "out_torch")
    _same_outputs("IDRome/to_all_atom.py",
                  lambda out: ["--cg-pdb", cg, "--sequence", seq, "--out", os.path.join(out, "aa.pdb")],
                  tmp_path, monkeypatch, 1)
