"""The port's metrics and analysis helpers against JAX's (CPU, numpy on
both sides). Two tetrapeptides from `build_peptide`, 60 frames each of the
structure plus seeded noise, are read by each package's own
`parse_datasets_from_directory`; fixed sample dicts (seeded numpy chains
around the structures, 3 batches of 2 chains per peptide) go through each
JAX metric class and its port. `compute()` must agree: arrays exactly,
floats to 1e-12, paths up to the output directory, and every file written
byte for byte. The same for the routing callback, for
`MeasureSamplingTimeCallback` over a fixed series of batches, for
`write_sampling_times_csv` / `get_sampling_rate`, and for
`load_run_trajectory` / `list_run_labels` on one directory."""

import os

import numpy as np
import pytest

import jamun_tpu.analysis.load_trajectory as j_load
import jamun_tpu.metrics as jm
from jamun_tpu.data.discovery import parse_datasets_from_directory as j_parse
from jamun_tpu.metrics import chemical_validity as j_chem
import jamun_tpu_torch.analysis.load_trajectory as t_load
import jamun_tpu_torch.metrics as tm
from jamun_tpu_torch.data.discovery import parse_datasets_from_directory as t_parse
from jamun_tpu_torch.data.peptide_builder import build_peptide
from jamun_tpu_torch.data.topology import save_pdb
from jamun_tpu_torch.metrics import chemical_validity as t_chem

SEQS = ("KWFE", "AGSV")
FRAMES = 60
PATTERNS = ("^(.*)-traj-arrays.npz", "^(.*)-traj-state0.pdb")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("peptides")
    rng = np.random.default_rng(0)
    for seq in SEQS:
        top, pos = build_peptide(seq)
        save_pdb(str(root / f"{seq}-traj-state0.pdb"), top, pos)
        frames = pos[None] + rng.normal(0.0, 0.03, (FRAMES,) + pos.shape)
        np.savez(root / f"{seq}-traj-arrays.npz", positions=frames.astype(np.float32))
    j_sets, t_sets = j_parse(str(root), *PATTERNS), t_parse(str(root), *PATTERNS)
    assert [d.label() for d in j_sets] == [d.label() for d in t_sets] == sorted(SEQS)
    return j_sets, t_sets


def _batches(t_sets):
    """3 batches; graphs 0-1 of dataset 0, 2-3 of dataset 1; each chain 7
    frames of the dataset's first frame plus N(0, 0.04 nm) noise (clashes
    and stretched bonds in some frames), and a score trajectory."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(3):
        batch = []
        for g in range(4):
            ds = t_sets[g // 2]
            x0 = ds[0][1]
            n = x0.shape[0]
            xhat = x0[:, None, :] + rng.normal(0.0, 0.04, (n, 7, 3))
            batch.append({"graph_index": g, "num_atoms": n, "xhat_traj": xhat.astype(np.float32),
                          "score_traj": rng.normal(0.0, 5.0, (n, 7, 3)).astype(np.float32)})
        out.append(batch)
    return out


def _same(got, want, tmp_got, tmp_want, where="result"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], tmp_got, tmp_want, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, tmp_got, tmp_want, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        assert np.array_equal(got, want), where
    elif isinstance(want, str):
        assert os.path.relpath(got, tmp_got) == os.path.relpath(want, tmp_want) if os.sep in want \
            else got == want, (where, got, want)
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= 1e-12 * max(1.0, abs(want)), (where, got, want)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _same_files(got_root, want_root):
    names = _files(want_root)
    assert _files(got_root) == names
    for name in names:
        with open(os.path.join(got_root, name), "rb") as a, open(os.path.join(want_root, name), "rb") as b:
            assert a.read() == b.read(), name


METRICS = {
    "TrajectoryMetric": lambda mod, ds, out: mod.TrajectoryMetric(ds),
    "SaveTrajectory": lambda mod, ds, out: mod.SaveTrajectory(ds, out),
    "RamachandranMetrics": lambda mod, ds, out: mod.RamachandranMetrics(ds),
    "RamachandranMetrics_no_reference": lambda mod, ds, out: mod.RamachandranMetrics(
        ds, num_bins=20, compare_with_reference=False),
    "ChemicalValidityMetrics": lambda mod, ds, out: mod.ChemicalValidityMetrics(ds),
    "ScoreDistributionMetrics": lambda mod, ds, out: mod.ScoreDistributionMetrics(ds),
    "SampleVisualizer": lambda mod, ds, out: mod.SampleVisualizer(ds, out),
    "TrajectoryVisualizer": lambda mod, ds, out: mod.TrajectoryVisualizer(ds, out, max_frames=5),
    "PoseBustersMetrics": lambda mod, ds, out: mod.PoseBustersMetrics(ds),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name, datasets, tmp_path):
    j_sets, t_sets = datasets
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in range(2):
        jmet = METRICS[name](jm, j_sets[d], out_j)
        tmet = METRICS[name](tm, t_sets[d], out_t)
        for batch in _batches(t_sets):
            for s in batch:
                if s["graph_index"] // 2 == d:
                    jmet.update(dict(s))
                    tmet.update(dict(s))
        want, got = jmet.compute(), tmet.compute()
        assert want  # something was computed
        _same(got, want, out_t, out_j)
    if os.path.isdir(out_j):
        _same_files(out_t, out_j)


def test_routing_callback_matches_jax(datasets):
    j_sets, t_sets = datasets
    per_graph = [0, 0, 1, 1]
    jcb = jm.TrajectoryMetricCallback([jm.ChemicalValidityMetrics(d) for d in j_sets], per_graph)
    tcb = tm.TrajectoryMetricCallback([tm.ChemicalValidityMetrics(d) for d in t_sets], per_graph)
    for batch in _batches(t_sets):
        jcb.on_after_sample_batch([dict(s) for s in batch], None)
        tcb.on_after_sample_batch([dict(s) for s in batch], None)
    jcb.on_sample_end(None)
    tcb.on_sample_end(None)
    _same(tcb.results, jcb.results, "", "")
    assert sorted(tcb.results) == sorted(SEQS[::-1])


def test_volume_exclusion_in_chunks_matches_jax():
    """More frames than one chunk (12 atoms scattered in a 1.5 nm box, so
    that about 40% of the frames have no clash): the same fraction and
    per-frame mask."""
    rng = np.random.default_rng(2)
    frames = rng.uniform(0.0, 1.5, (2 * t_chem._FRAMES_PER_CHUNK + 37, 12, 3))
    elements, bonds = ["C", "N", "O", "S"] * 3, [(0, 1), (1, 2), (5, 9)]
    want_rate, want_ok = j_chem.volume_exclusion_rate(frames, elements, bonds)
    got_rate, got_ok = t_chem.volume_exclusion_rate(frames, elements, bonds)
    assert 0.2 < want_rate < 0.8
    assert got_rate == want_rate and np.array_equal(got_ok, want_ok)


def test_divergences_and_torsions_match_jax(datasets):
    rng = np.random.default_rng(3)
    p, q = rng.random(50), rng.random(50)
    assert tm.jensen_shannon_divergence(p, q) == jm.jensen_shannon_divergence(p, q)
    x1, y1, x2, y2 = (rng.uniform(-np.pi, np.pi, 200) for _ in range(4))
    assert tm.histogram_jsd_2d(x1, y1, x2, y2, bins=30) == jm.histogram_jsd_2d(x1, y1, x2, y2, bins=30)
    X, Y = rng.standard_normal((300, 6)), rng.standard_normal((250, 6)) + 0.2
    for seed in (0, 5):
        assert tm.sliced_wasserstein_distance(X, Y, 20, seed) == jm.sliced_wasserstein_distance(X, Y, 20, seed)
    j_sets, t_sets = datasets
    for jd, td in zip(j_sets, t_sets):
        traj = np.asarray(td.trajectory)
        for a, b in zip(tm.compute_phi_psi(td.template.topology, traj),
                        jm.compute_phi_psi(jd.template.topology, traj)):
            assert np.array_equal(a, b)


def _timing_series():
    """(sample lists, elapsed seconds, overflow) of four batches."""
    series = []
    for b, secs in enumerate((2.5, 0.31, 0.29, 0.33)):
        sample = [{"graph_index": g, "xhat_traj": np.zeros((5, 10 + g, 3), np.float32)} for g in range(3)]
        overflow = {"mean": 0.25 * b, "max": b} if b >= 2 else None
        series.append((sample, secs, overflow))
    return series


@pytest.mark.parametrize("batches", [1, 4])
def test_sampling_time_callback_matches_jax(batches):
    labels = ["KWFE", "KWFE", "AGSV"]
    jcb, tcb = jm.MeasureSamplingTimeCallback(labels), tm.MeasureSamplingTimeCallback(labels)
    for sample, secs, overflow in _timing_series()[:batches]:
        jcb.on_after_sample_batch(sample, None, elapsed_seconds=secs, neighbor_overflow=overflow)
        tcb.on_after_sample_batch(sample, None, elapsed_seconds=secs, neighbor_overflow=overflow)
    assert tcb.per_batch == jcb.per_batch
    assert tcb.last_neighbor_overflow == jcb.last_neighbor_overflow
    assert tcb.rates() == jcb.rates()
    rates = tcb.rates()["KWFE"]
    if batches > 1:  # the warm rate leaves batch 0 out
        assert rates["time_per_sample_seconds"] < rates["time_per_sample_seconds_incl_compile"]


def test_sampling_times_csv_matches_jax(tmp_path):
    cb = tm.MeasureSamplingTimeCallback(["KWFE", "KWFE", "AGSV"])
    for sample, secs, overflow in _timing_series():
        cb.on_after_sample_batch(sample, None, elapsed_seconds=secs, neighbor_overflow=overflow)
    rows = cb.rates()
    for r in rows.values():
        r["neighbor_overflow_mean"] = cb.last_neighbor_overflow["mean"]
        r["neighbor_overflow_max"] = cb.last_neighbor_overflow["max"]
    for rates in (rows, {"KWFE": 0.0012, "AGSV": 0.5}):
        j_path, t_path = str(tmp_path / "j" / "times.csv"), str(tmp_path / "t" / "times.csv")
        j_load.write_sampling_times_csv(j_path, rates)
        t_load.write_sampling_times_csv(t_path, rates)
        with open(j_path) as a, open(t_path) as b:
            assert b.read() == a.read()
        for label in ("KWFE", "AGSV", "missing"):
            assert t_load.get_sampling_rate(t_path, label) == j_load.get_sampling_rate(j_path, label)


def test_load_run_trajectory_matches_jax(datasets, tmp_path):
    _, t_sets = datasets
    run = str(tmp_path / "run")
    savers = [tm.SaveTrajectory(d, os.path.join(run, "sampler")) for d in t_sets]
    for batch in _batches(t_sets):
        for s in batch:
            savers[s["graph_index"] // 2].update(s)
    assert t_load.list_run_labels(run) == j_load.list_run_labels(run) == sorted(SEQS)
    for joined in (True, False):
        for saver in savers:
            label = saver.dataset.label()
            if joined:
                saver.compute()
            else:
                os.remove(os.path.join(saver.output_dir, "joined_trajectory.dcd"))
            (t_top, t_pos), (j_top, j_pos) = (t_load.load_run_trajectory(run, label),
                                              j_load.load_run_trajectory(run, label))
            assert t_pos.dtype == j_pos.dtype and np.array_equal(t_pos, j_pos)
            assert t_pos.shape == (3 * 2 * 7, saver.template.num_atoms, 3)
            assert [a.name for a in t_top.atoms] == [a.name for a in j_top.atoms]
            assert sorted(t_top.bonds) == sorted(j_top.bonds)
