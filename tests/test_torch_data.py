"""The port's data slice against JAX's (CPU, numpy): vocabularies, PDB and
DCD files, `build_peptide`, padding and collation, discovery, the
DataModule's batch order, and the normalization pre-pass. The same numpy
code on both sides, so everything is held to exact equality, except
`build_peptide`'s positions: 1e-6 nm.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from jamun_tpu.data import batching as jbatching
from jamun_tpu.data import dcd as jdcd
from jamun_tpu.data import residue_metadata as jrm
from jamun_tpu.data import topology as jtop
from jamun_tpu.data.datamodule import DataModule as JDataModule
from jamun_tpu.data.discovery import parse_datasets_from_directory as j_parse
from jamun_tpu.data.peptide_builder import build_peptide as j_build_peptide
from jamun_tpu.utils.average_squared_distance import (
    compute_average_squared_distance_from_datasets as j_asd,
)
from jamun_tpu_torch.data import batching, dcd, residue_metadata as rm, topology
from jamun_tpu_torch.data.datamodule import DataModule
from jamun_tpu_torch.data.discovery import parse_datasets_from_directory
from jamun_tpu_torch.data.peptide_builder import build_peptide
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.utils.average_squared_distance import compute_average_squared_distance_from_datasets

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from make_synthetic_data import make_molecule, make_trajectory  # noqa: E402

SEQUENCES = ["AG", "KWFE", "ACDEFGHIKLMNPQRSTVWY"]


def _write_dataset(root, specs):
    """Timewarp layout: <code>-traj-arrays.npz and <code>-traj-state0.pdb,
    from the repo's synthetic molecules and built peptides."""
    os.makedirs(root, exist_ok=True)
    for code, kind, n_frames, seed in specs:
        if kind == "synthetic":
            top, pos0 = make_molecule(2, seed=seed)
        else:
            top, pos0 = j_build_peptide(kind)
        traj = make_trajectory(pos0, n_frames, seed=100 + seed)
        jtop.save_pdb(os.path.join(root, f"{code}-traj-state0.pdb"), top, pos0)
        np.savez(os.path.join(root, f"{code}-traj-arrays.npz"), positions=traj)
    return str(root)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return _write_dataset(tmp_path_factory.mktemp("data") / "train", [
        ("AG", "synthetic", 37, 0), ("SV", "synthetic", 29, 1), ("KWFE", "KWFE", 23, 2),
        ("GGA", "GGA", 11, 3),
    ])


def test_vocabularies_equal():
    for name in ("ATOM_TYPES", "ATOM_CODES", "RESIDUE_CODES", "AA_3CODES", "AA_1CODES"):
        assert getattr(rm.ResidueMetadata, name) == getattr(jrm.ResidueMetadata, name), name
    for s in ["C", "O", "N", "S", "CA", "CB", "H", "XX", "ALA", "NME", "UNK", "CD1"]:
        assert rm.encode_atom_type(s) == jrm.encode_atom_type(s)
        assert rm.encode_atom_code(s) == jrm.encode_atom_code(s)
        assert rm.encode_residue(s) == jrm.encode_residue(s)
    for seq in ["AGW", "ALA_GLY_TRP", "KWFE"]:
        assert rm.convert_to_three_letter_codes(seq) == jrm.convert_to_three_letter_codes(seq)
        assert rm.convert_to_one_letter_codes(seq) == jrm.convert_to_one_letter_codes(seq)


@pytest.mark.parametrize("seq", SEQUENCES + ["capped:AK"])
def test_build_peptide_matches_jax(seq):
    """Positions within 1e-6 nm, the topology (atoms, inferred bonds) equal."""
    capped = seq.startswith("capped:")
    seq = seq.split(":")[-1]
    top, pos = build_peptide(seq, capped=capped)
    jtop_, jpos = j_build_peptide(seq, capped=capped)
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-6)
    assert [dataclasses.astuple(a) for a in top.atoms] == [dataclasses.astuple(a) for a in jtop_.atoms]
    assert top.bonds == jtop_.bonds and len(top.bonds) >= len(top.atoms) - 1


@pytest.mark.parametrize("kind", ["synthetic", "KWFE", "capped:AK"])
def test_pdb_round_trip_matches_jax(kind, tmp_path):
    """save_pdb writes the same bytes; load_pdb (bonds inferred from the
    coordinates) gives the same topology and positions; preprocess_topology
    the same GraphTemplate arrays."""
    if kind == "synthetic":
        top, pos = make_molecule(3, seed=4)
    else:
        top, pos = j_build_peptide(kind.split(":")[-1], capped=kind.startswith("capped"))
    frames = np.stack([pos, pos + 0.01]).astype(np.float32)
    a, b = tmp_path / "port.pdb", tmp_path / "jax.pdb"
    topology.save_pdb(str(a), topology.Topology(atoms=top.atoms, bonds=top.bonds), frames)
    jtop.save_pdb(str(b), top, frames)
    assert a.read_bytes() == b.read_bytes()
    got_top, got_pos = topology.load_pdb(str(a))
    want_top, want_pos = jtop.load_pdb(str(b))
    np.testing.assert_array_equal(got_pos, want_pos)
    assert [dataclasses.astuple(x) for x in got_top.atoms] == [dataclasses.astuple(x) for x in want_top.atoms]
    assert got_top.bonds == want_top.bonds
    got, _, _ = topology.preprocess_topology(got_top, got_pos[0])
    want, _, _ = jtop.preprocess_topology(want_top, want_pos[0])
    for f in ("atom_type_index", "atom_code_index", "residue_code_index", "residue_sequence_index",
              "bond_src", "bond_dst"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.num_residues, got.residues, got.atom_names) == (want.num_residues, want.residues, want.atom_names)


def test_dcd_bytes_both_ways(tmp_path):
    pos = np.random.default_rng(0).standard_normal((5, 13, 3)).astype(np.float32)
    a, b = tmp_path / "port.dcd", tmp_path / "jax.dcd"
    dcd.write_dcd(str(a), pos)
    jdcd.write_dcd(str(b), pos)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(dcd.read_dcd(str(b)), jdcd.read_dcd(str(b)))
    np.testing.assert_array_equal(jdcd.read_dcd(str(a)), dcd.read_dcd(str(a)))


def _templates(data_root):
    port = parse_datasets_from_directory(data_root, "^(.*)-traj-arrays.npz", "^(.*)-traj-state0.pdb")
    jax_ = j_parse(data_root, "^(.*)-traj-arrays.npz", "^(.*)-traj-state0.pdb")
    return port, jax_


def test_discovery_and_datasets_match_jax(data_root):
    port, jax_ = _templates(data_root)
    assert [d.label() for d in port] == [d.label() for d in jax_] == ["AG", "GGA", "KWFE", "SV"]
    for p, j in zip(port, jax_):
        np.testing.assert_array_equal(p.trajectory, j.trajectory)
        np.testing.assert_array_equal(p.template.bond_src, j.template.bond_src)
    sub = parse_datasets_from_directory(data_root, "^(.*)-traj-arrays.npz", "^(.*)-traj-state0.pdb",
                                        filter_codes=["KWFE"], subsample=3, start_frame=1)
    jsub = j_parse(data_root, "^(.*)-traj-arrays.npz", "^(.*)-traj-state0.pdb",
                   filter_codes=["KWFE"], subsample=3, start_frame=1)
    np.testing.assert_array_equal(sub[0].trajectory, jsub[0].trajectory)


def _assert_batch_equal(got: GraphBatch, want):
    for f in dataclasses.fields(GraphBatch):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_pad_to_bucket_and_collate_match_jax(data_root):
    """Field by field: `pad_to_bucket` with the residue layout, and
    `collate` of a batch of mixed sizes padded to its largest bucket, with
    dummy graphs (the port's `GraphBatch`: int64 indices, bool masks)."""
    port, jax_ = _templates(data_root)
    spec, jspec = batching.BucketSpec(), jbatching.BucketSpec()
    for p, j in zip(port, jax_):
        n_pad = spec.node_bucket(p.template.num_atoms)
        assert n_pad == jspec.node_bucket(j.template.num_atoms)
        args = (n_pad, spec.bond_bucket(n_pad), spec.residue_bucket(p.template.num_residues), 16)
        got = batching.pad_to_bucket(p.template, p[3][1], *args)
        want = jbatching.pad_to_bucket(j.template, j[3][1], *args)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    items = [port[2][0], port[0][5], port[3][1]]
    jitems = [jax_[2][0], jax_[0][5], jax_[3][1]]
    got = batching.collate(items, num_graphs=5)
    _assert_batch_equal(got, jbatching.collate(jitems, num_graphs=5))
    assert got.pos.shape == (5, 48, 3) and str(got.bond_src.dtype) == "torch.int64"
    _assert_batch_equal(batching.template_to_batch(port[1].template, port[1].trajectory[:2], 3),
                        jbatching.template_to_batch(jax_[1].template, jax_[1].trajectory[:2], 3))


@pytest.mark.parametrize("shuffle,streaming", [(True, False), (False, False), (False, True)])
def test_datamodule_batch_order_matches_jax(data_root, shuffle, streaming):
    """The same batches in the same order for a seed: two shuffled epochs
    (bucket grouping), the validation pass, and the streaming interleave;
    the port's through its prefetch thread."""
    port, jax_ = _templates(data_root)
    kw = dict(batch_size=8, shuffle=shuffle, seed=3, streaming=streaming)
    dm = DataModule(datasets=port, val_datasets=port[:2], **kw)
    jdm = JDataModule(datasets=jax_, val_datasets=jax_[:2], **kw)
    for epoch in range(2):
        got, want = dm.train_batches(epoch), jdm.train_batches(epoch)
        n = 0
        for g, w in zip(got, want):
            _assert_batch_equal(g, w)
            n += 1
            if streaming and n == 6:
                break
        assert n == (6 if streaming else len(list(jdm.train_batches(epoch))))
    if not streaming:
        vals = list(dm.val_batches())
        jvals = list(jdm.val_batches())
        assert len(vals) == len(jvals) > 0
        for g, w in zip(vals, jvals):
            _assert_batch_equal(g, w)


def test_prefetch_raises_the_worker_error():
    """An error while collating in the prefetch thread reaches the consumer."""

    class Broken:
        template = dataclasses.make_dataclass("T", [("num_atoms", int)])(4)

        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise RuntimeError("frame unreadable")

    with pytest.raises(RuntimeError, match="frame unreadable"):
        list(DataModule(datasets=[Broken()], batch_size=2).train_batches(0))


def test_average_squared_distance_matches_jax(data_root):
    port, jax_ = _templates(data_root)
    for cutoff in (0.5, 1.0):
        assert compute_average_squared_distance_from_datasets(port, cutoff) == j_asd(jax_, cutoff)
