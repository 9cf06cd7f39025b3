"""The port's trajio (`jamun_tpu_torch/csrc/trajio.cpp`, built with g++ into
`jamun_tpu_torch/_build/`) against JAX's (`native/trajio`, CPU): XTC files
byte for byte and reads exactly, the round trip, DCD against the numpy
codec, the corrupt streams JAX rejects, where the library is built, and an
IDRome-layout tree (hydrogens in `top.pdb`) through the datasets, map-style
and streaming, against JAX's datasets on the same files.

The codec is integer arithmetic after one multiply and a round half away
from zero, so everything is held to exact equality except the round trip
(0.5 / precision).
"""

import dataclasses
import itertools
import os
import shutil
import struct

import numpy as np
import pytest

from jamun_tpu.data import batching as jbatching
from jamun_tpu.data.datamodule import DataModule as JDataModule
from jamun_tpu.data.datasets import (
    IterableTrajectoryDataset as JIterable,
    TrajectoryDataset as JTrajectoryDataset,
)
from jamun_tpu.data.discovery import parse_datasets_from_directory as j_parse
from jamun_tpu_torch.data import _native_io, batching, build_native, dcd
from jamun_tpu_torch.data.datamodule import DataModule
from jamun_tpu_torch.data.datasets import _load_traj_positions
from jamun_tpu_torch.data.discovery import parse_datasets_from_directory
from jamun_tpu_torch.data.topology import load_pdb
from jamun_tpu_torch.data.xtc import read_xtc, write_xtc
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.utils.testing import idr_sequence, write_idrome_tree

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

REPO = os.path.join(os.path.dirname(__file__), "..")
IDROME = (r"^(.*)/traj\.xtc", r"^(.*)/top\.pdb")


def jax_trajio():
    """JAX's bindings (`jamun_tpu.data._native_io`). Their import builds
    JAX's library when it is missing, with g++ writing straight into the
    library's path, so another test process could load a half-written file:
    here it is built first into a temporary file, renamed into place, under
    a lock that the test processes share."""
    import fcntl
    import tempfile

    from jamun_tpu.data import build_native as jbuild

    with open(os.path.join(tempfile.gettempdir(), "jamun_tpu_trajio_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        out, src = jbuild.OUT, os.path.normpath(jbuild.NATIVE_SRC)
        if not os.path.exists(out) or os.path.getmtime(src) > os.path.getmtime(out):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
            os.close(fd)
            jbuild.OUT = tmp
            try:
                jbuild.build(verbose=False)
            finally:
                jbuild.OUT = out
            os.chmod(tmp, 0o755)
            os.replace(tmp, out)
        from jamun_tpu.data import _native_io as jio
    return jio


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "random":
        return (rng.standard_normal((5, 33, 3)) * 0.5).astype(np.float32)
    if name == "one_atom":
        return (rng.standard_normal((3, 1, 3)) * 0.5).astype(np.float32)
    if name == "nine_atoms":  # stored uncompressed (natoms <= 9)
        return (rng.standard_normal((4, 9, 3)) * 0.5).astype(np.float32)
    if name == "ten_atoms":  # the first compressed size
        return (rng.standard_normal((4, 10, 3)) * 0.5).astype(np.float32)
    if name == "chain":  # closely spaced: small runs and the water swap
        return np.cumsum(rng.uniform(0.01, 0.02, size=(3, 64, 3)), axis=1).astype(np.float32)
    if name == "large":  # a range above 2^24 integers: each coordinate's own bit size
        return (rng.uniform(-9000.0, 9000.0, size=(2, 40, 3))).astype(np.float32)
    raise KeyError(name)


CASES = ["random", "one_atom", "nine_atoms", "ten_atoms", "chain", "large"]


@pytest.mark.parametrize("case", CASES)
def test_xtc_bytes_and_reads_equal_jax(case, tmp_path):
    """The port's file equals JAX's byte for byte; the port reads JAX's file
    to JAX's array exactly, and JAX reads the port's to the port's."""
    jio = jax_trajio()
    pos = _case(case)
    mine, theirs = str(tmp_path / "port.xtc"), str(tmp_path / "jax.xtc")
    write_xtc(mine, pos)
    jio.write_xtc(theirs, pos)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    want = jio.read_xtc(theirs)
    got = read_xtc(theirs)
    assert got.dtype == want.dtype == np.float32 and got.shape == pos.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jio.read_xtc(mine), read_xtc(mine))


@pytest.mark.parametrize("precision", [1000.0, 100.0])
@pytest.mark.parametrize("case", ["random", "nine_atoms", "chain"])
def test_xtc_round_trip(case, precision, tmp_path):
    """Read back within 0.5 / precision (and a float's rounding); the
    uncompressed branch exactly."""
    pos = _case(case)
    path = str(tmp_path / "t.xtc")
    _native_io.write_xtc(path, pos, precision=precision)
    back = _native_io.read_xtc(path)
    if pos.shape[1] <= 9:
        np.testing.assert_array_equal(back, pos)
    else:
        assert np.abs(back - pos).max() <= 0.5 / precision + 1e-6 * np.abs(pos).max()


def test_dcd_native_against_numpy(tmp_path):
    """The library writes JAX's library's bytes and reads as JAX's library
    does, its own files and the numpy codec's; both codecs agree within a
    float's rounding."""
    jio = jax_trajio()
    pos = (np.random.default_rng(0).standard_normal((5, 17, 3)) * 0.4).astype(np.float32)
    native, numpy_, theirs = (str(tmp_path / f"{k}.dcd") for k in ("native", "numpy", "jax"))
    _native_io.write_dcd(native, pos)
    dcd.write_dcd(numpy_, pos)
    jio.write_dcd(theirs, pos)
    assert open(native, "rb").read() == open(theirs, "rb").read()
    for path in (native, numpy_):
        np.testing.assert_array_equal(_native_io.read_dcd(path), jio.read_dcd(path))
        # the library multiplies by 0.1f, the numpy codec divides by 10: an ulp apart
        np.testing.assert_allclose(_native_io.read_dcd(path), dcd.read_dcd(path), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_native_io.read_dcd(path), pos, rtol=0, atol=1e-6)


def _corrupt_natoms(path: str) -> None:
    """JAX's case (`tests/test_round3_fixes.py`): a 32-atom chain whose two
    atom counts are patched to 12, so the bitstream claims more atoms."""
    pos = np.cumsum(np.random.default_rng(0).uniform(0.01, 0.02, size=(1, 32, 3)), axis=1)
    write_xtc(path, pos.astype(np.float32))
    raw = bytearray(open(path, "rb").read())
    for off in (4, 52):
        assert struct.unpack_from(">i", raw, off)[0] == 32
        struct.pack_into(">i", raw, off, 12)
    open(path, "wb").write(bytes(raw))


def _corrupt_smallidx(path: str) -> None:
    """JAX's other case: smallidx beyond the table."""
    write_xtc(path, np.cumsum(np.full((1, 16, 3), 0.015, np.float32), axis=1))
    raw = bytearray(open(path, "rb").read())
    struct.pack_into(">i", raw, 84, 99)
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("corrupt", [_corrupt_natoms, _corrupt_smallidx])
def test_corrupt_xtc_raises(corrupt, tmp_path):
    path = str(tmp_path / "bad.xtc")
    corrupt(path)
    with pytest.raises(IOError):
        read_xtc(path)
    with pytest.raises(IOError):
        jax_trajio().read_xtc(path)


def test_missing_file_and_bad_shape_raise(tmp_path):
    with pytest.raises(IOError):
        read_xtc(str(tmp_path / "absent.xtc"))
    with pytest.raises(IOError):
        _native_io.read_dcd(str(tmp_path / "absent.dcd"))
    for write in (write_xtc, _native_io.write_dcd):  # one frame without its frame axis
        with pytest.raises(ValueError, match="frames, atoms, 3"):
            write(str(tmp_path / "flat"), np.zeros((12, 3), np.float32))


def test_library_is_built_in_the_port_only(tmp_path):
    """The port builds its own source (`csrc/trajio.cpp`, whose codec is
    JAX's text) into `jamun_tpu_torch/_build/`, named by the source and the
    flags, with no host-specific flag; the library it loads is that one."""
    pkg = os.path.normpath(os.path.join(REPO, "jamun_tpu_torch"))
    assert str(build_native.SOURCE) == os.path.join(pkg, "csrc", "trajio.cpp")
    lib = build_native.build()
    assert lib == build_native.library_path() and lib.exists()
    assert str(lib.parent) == os.path.join(pkg, "_build")
    assert lib.name.startswith("libtrajio_") and "-march=native" not in build_native.FLAGS
    write_xtc(str(tmp_path / "a.xtc"), _case("random"))  # loads through the bindings
    assert _native_io._lib._name == str(lib)
    # the codec and the C API are JAX's, line for line
    ours = open(build_native.SOURCE).read()
    theirs = open(os.path.join(REPO, "native", "trajio", "trajio.cpp")).read()
    start = theirs.index("#include <cstdio>")
    end = theirs.index("// -------------------------------------------- batched collate")
    assert theirs[start:end].rstrip() + '\n}  // extern "C"\n' == ours[ours.index("#include <cstdio>"):]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """g++ failing raises RuntimeError (no fallback), and leaves no library."""
    bad = tmp_path / "trajio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build_native, "SOURCE", bad)
    monkeypatch.setattr(build_native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build_native.build()
    assert not list((tmp_path / "_build").glob("*.so"))


# ------------------------------------------------ the IDRome layout


@pytest.fixture(scope="module")
def idrome_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("idrome"))
    heavy = write_idrome_tree(root, {"idr_b": idr_sequence(40, 2), "idr_a": idr_sequence(70, 1)},
                              frames=12, seed=4)
    return root, heavy


def test_idrome_tree_has_hydrogens(idrome_root):
    """`top.pdb` lists hydrogens; the trajectory holds every atom; the
    loader reads it whole."""
    root, heavy = idrome_root
    for name, n in heavy.items():
        full, _ = load_pdb(os.path.join(root, name, "top.pdb"))
        n_h = sum(a.element == "H" for a in full.atoms)
        assert n_h > 0 and full.n_atoms == n + n_h
        xyz = _load_traj_positions(os.path.join(root, name, "traj.xtc"))
        assert xyz.shape == (12, full.n_atoms, 3)


def _jax_sets(root, names, iterable):
    """JAX's datasets on the same files, built directly: JAX's discovery
    lists `root` alone and finds no pair in this layout."""
    cls = JIterable if iterable else JTrajectoryDataset
    return [cls(root=root, trajfiles=(f"{n}/traj.xtc",), pdbfile=f"{n}/top.pdb", label=n)
            for n in names]


def _assert_batch_equal(got: GraphBatch, want):
    for f in dataclasses.fields(GraphBatch):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_idrome_discovery_and_map_style_match_jax(idrome_root):
    """Labels are the directory names; heavy-atom frames, templates and
    padded batches equal JAX's."""
    root, heavy = idrome_root
    port = parse_datasets_from_directory(root, *IDROME, subsample=2)
    with pytest.raises(ValueError, match="No \\(trajectory, pdb\\) pairs"):
        j_parse(root, *IDROME)
    assert [d.label() for d in port] == sorted(heavy) == ["idr_a", "idr_b"]
    jax_ = [JTrajectoryDataset(root=root, trajfiles=(f"{n}/traj.xtc",), pdbfile=f"{n}/top.pdb",
                               label=n, subsample=2) for n in sorted(heavy)]
    for p, j in zip(port, jax_):
        assert p.trajectory.shape == (6, heavy[p.label()], 3)
        np.testing.assert_array_equal(p.trajectory, j.trajectory)
        for k in ("atom_type_index", "atom_code_index", "residue_code_index",
                  "residue_sequence_index", "bond_src", "bond_dst"):
            np.testing.assert_array_equal(getattr(p.template, k), getattr(j.template, k), err_msg=k)
    items = [port[0][1], port[1][0], port[0][5]]
    got = batching.collate(items, num_graphs=4)
    _assert_batch_equal(got, jbatching.collate([jax_[0][1], jax_[1][0], jax_[0][5]], num_graphs=4))
    assert got.pos.shape[:2] == (4, batching.BucketSpec().node_bucket(max(heavy.values())))


def test_idrome_streaming_matches_jax(idrome_root):
    """The streaming datasets (`as_iterable`, as the IDRome configs read
    them) yield JAX's frames, and the streaming DataModule JAX's batches."""
    root, heavy = idrome_root
    port = parse_datasets_from_directory(root, *IDROME, as_iterable=True)
    jax_ = _jax_sets(root, sorted(heavy), iterable=True)
    for p, j in zip(port, jax_):
        got, want = list(p), list(j)
        assert len(got) == len(want) == 12
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    kw = dict(batch_size=3, seed=5, streaming=True)
    dm, jdm = DataModule(datasets=port, **kw), JDataModule(datasets=jax_, **kw)
    for n, (g, w) in enumerate(zip(dm.train_batches(0), jdm.train_batches(0))):
        _assert_batch_equal(g, w)
        if n == 9:  # past the end of each stream: re-opened
            break


@pytest.mark.parametrize("frames", [1, 12])
def test_stream_normalization_equals_map_style(frames, tmp_path):
    """The normalization pre-pass on the streaming datasets equals the
    map-style pass on the same frames: one frame a protein (per_ds = 1), or
    every frame (per_ds above the length: the map-style pass draws them all,
    in another order)."""
    from jamun_tpu_torch.utils.average_squared_distance import (
        compute_average_squared_distance_from_datasets as asd,
    )

    root = str(tmp_path)
    heavy = write_idrome_tree(root, {"idr_b": idr_sequence(40, 2), "idr_a": idr_sequence(70, 1)},
                              frames=frames, seed=9)
    stream = parse_datasets_from_directory(root, *IDROME, as_iterable=True)
    mapped = parse_datasets_from_directory(root, *IDROME)
    max_graphs = len(heavy) * frames
    got, want = asd(stream, 1.0, max_graphs=max_graphs), asd(mapped, 1.0, max_graphs=max_graphs)
    if frames == 1:
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)


def test_stream_normalization_is_the_same_on_every_run(idrome_root, tmp_path):
    """A stream of two files with `start_at_random_frame` iterates its files
    in `np.random`'s order (JAX's behaviour, kept), but the pre-pass reads
    them in their listed order: the first file's first frames, whatever the
    global random state."""
    from jamun_tpu_torch.data.datasets import IterableTrajectoryDataset
    from jamun_tpu_torch.utils.average_squared_distance import (
        compute_average_squared_distance,
        compute_average_squared_distance_from_datasets as asd,
    )

    src, _ = idrome_root
    shutil.copy(os.path.join(src, "idr_b", "top.pdb"), tmp_path / "top.pdb")
    xyz = _load_traj_positions(os.path.join(src, "idr_b", "traj.xtc"))
    write_xtc(str(tmp_path / "a.xtc"), xyz[:4])
    write_xtc(str(tmp_path / "b.xtc"), xyz[4:8] + np.float32(0.3))
    ds = IterableTrajectoryDataset(root=str(tmp_path), trajfiles=("a.xtc", "b.xtc"),
                                   pdbfile="top.pdb", label="idr_b", start_at_random_frame=True)
    first = [frame for _, frame in itertools.islice(ds.frames(), 3)]
    want = float(np.mean([compute_average_squared_distance(f, 1.0) for f in first]))
    firsts, values = set(), set()
    state = np.random.get_state()
    try:
        for seed in range(8):
            np.random.seed(seed)
            firsts.add(next(iter(ds))[1].tobytes())
            np.random.seed(seed)
            values.add(asd([ds], 1.0, max_graphs=3))
    finally:
        np.random.set_state(state)
    assert len(firsts) == 2  # the iterator shuffles its files
    assert values == {want}
