"""The port's analysis (`jamun_tpu_torch/analysis/`) against JAX's on the same
numpy inputs (CPU): TICA, the MSM, k-means, `analyze_trajectories`, the
`run_analysis` CLI and `analysis_sweep` on an IDRome-layout `.xtc`
reference. The same numpy code on both sides, so the results are held to
exact equality.
"""

import json
import os

import numpy as np
import pytest

from jamun_tpu.analysis import analysis_sweep as j_sweep
from jamun_tpu.analysis import run_analysis as j_run
from jamun_tpu.analysis.msm import MSM as JMSM, kmeans as j_kmeans
from jamun_tpu.analysis.tica import TICA as JTICA
from jamun_tpu.data.topology import load_pdb as j_load_pdb
from jamun_tpu_torch.analysis import analysis_sweep, run_analysis
from jamun_tpu_torch.analysis.msm import MSM, kmeans
from jamun_tpu_torch.analysis.tica import TICA
from jamun_tpu_torch.data.dcd import write_dcd
from jamun_tpu_torch.data.peptide_builder import build_peptide
from jamun_tpu_torch.data.topology import load_pdb, save_pdb
from jamun_tpu_torch.utils.testing import write_idrome_tree
from test_torch_xtc import jax_trajio


def _slow_trajectory(T, d, seed):
    """A correlated random walk (so TICA finds slow directions)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((T, d))
    for t in range(1, T):
        x[t] = 0.95 * x[t - 1] + rng.standard_normal(d)
    return x


@pytest.mark.parametrize("dim", [None, 3])
def test_tica_equals_jax(dim):
    trajs = [_slow_trajectory(300, 6, 0), _slow_trajectory(150, 6, 1), _slow_trajectory(4, 6, 2)]
    port, jax_ = TICA(lag=5, dim=dim).fit(trajs), JTICA(lag=5, dim=dim).fit(trajs)
    for k in ("mean_", "eigenvalues_", "eigenvectors_"):
        np.testing.assert_array_equal(getattr(port, k), getattr(jax_, k), err_msg=k)
    np.testing.assert_array_equal(port.transform(trajs[1]), jax_.transform(trajs[1]))
    np.testing.assert_array_equal(port.timescales(), jax_.timescales())
    with pytest.raises(ValueError, match="no trajectory longer than lag"):
        TICA(lag=400).fit(trajs)


@pytest.mark.parametrize("k,seed", [(4, 0), (9, 3)])
def test_kmeans_equals_jax(k, seed):
    X = np.random.default_rng(10 + seed).standard_normal((120, 2)) * [1.0, 0.3]
    centers, labels = kmeans(X, k, seed=seed)
    j_centers, j_labels = j_kmeans(X, k, seed=seed)
    np.testing.assert_array_equal(centers, j_centers)
    np.testing.assert_array_equal(labels, j_labels)


def test_msm_equals_jax():
    rng = np.random.default_rng(4)
    dtrajs = [rng.integers(0, 6, 200), rng.integers(0, 6, 50), rng.integers(0, 6, 2)]
    for lag in (1, 3):
        port, jax_ = MSM(lag=lag).fit(dtrajs), JMSM(lag=lag).fit(dtrajs)
        np.testing.assert_array_equal(port.transition_matrix_, jax_.transition_matrix_)
        np.testing.assert_array_equal(port.stationary_distribution_, jax_.stationary_distribution_)
        assert port.n_states == jax_.n_states == 6
        np.testing.assert_array_equal(port.metastable_probabilities(), jax_.metastable_probabilities())


def _peptide_frames(seq, frames, noise, seed):
    top, pos = build_peptide(seq)
    rng = np.random.default_rng(seed)
    return top, (pos[None] + rng.normal(0.0, noise, (frames,) + pos.shape)).astype(np.float32)


def _assert_same_result(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k] or np.array_equal(got[k], want[k]), k


def test_analyze_trajectories_equals_jax(tmp_path):
    """Every key, the TICA/MSM stage's included, equal to JAX's (each side
    on its own topology of the same PDB)."""
    top, ref = _peptide_frames("KWFEAG", 150, 0.03, 0)
    _, pred = _peptide_frames("KWFEAG", 90, 0.04, 1)
    save_pdb(str(tmp_path / "top.pdb"), top, ref[0])
    top, jtop = load_pdb(str(tmp_path / "top.pdb"))[0], j_load_pdb(str(tmp_path / "top.pdb"))[0]
    got = run_analysis.analyze_trajectories(top, pred, ref, tica_lag=1000)
    want = j_run.analyze_trajectories(jtop, pred, ref, tica_lag=1000)
    assert {"tica0_jsd", "tica01_jsd", "msm_state_jsd", "ramachandran_jsd"} <= set(want)
    _assert_same_result(got, want)
    # the helpers
    np.testing.assert_array_equal(run_analysis.autocovariance(pred[:, 0, 0], 30),
                                  j_run.autocovariance(pred[:, 0, 0], 30))
    np.testing.assert_array_equal(run_analysis.subset_reference_trajectory(pred, ref, 0.01, 0.02),
                                  j_run.subset_reference_trajectory(pred, ref, 0.01, 0.02))


@pytest.mark.parametrize("speed_matched", ["none", "rerun", "saturated"])
def test_run_analysis_cli_equals_jax(tmp_path, speed_matched):
    """The CLI's JSON files (and the `_benchmark` file of the speed-matched
    rerun, or its saturated record) equal JAX's."""
    top, ref = _peptide_frames("AGS", 140, 0.03, 2)
    _, pred = _peptide_frames("AGS", 60, 0.04, 3)
    pdb = str(tmp_path / "top.pdb")
    save_pdb(pdb, top, ref[0])
    write_dcd(str(tmp_path / "pred.dcd"), pred)
    np.savez(str(tmp_path / "ref.npz"), positions=ref)
    extra = {"none": [], "rerun": ["--pred-seconds-per-sample", "0.001", "--ref-seconds-per-sample",
                                   "0.01"],
             "saturated": ["--pred-seconds-per-sample", "1", "--ref-seconds-per-sample", "0.01"]}
    outs = {}
    for name, mod in (("port", run_analysis), ("jax", j_run)):
        out = str(tmp_path / f"{name}.json")
        mod.main(["--pdb", pdb, "--pred", str(tmp_path / "pred.dcd"), "--ref", str(tmp_path / "ref.npz"),
                  "--out", out, "--tica-lag", "20", *extra[speed_matched]])
        outs[name] = out
    for suffix in ("", "_benchmark"):
        paths = [p.replace(".json", f"{suffix}.json") for p in (outs["port"], outs["jax"])]
        assert os.path.exists(paths[0]) == os.path.exists(paths[1]) == (
            suffix == "" or speed_matched != "none")
        if os.path.exists(paths[0]):
            got, want = (json.load(open(p)) for p in paths)
            assert got == want
    if speed_matched == "saturated":
        assert "skipped" in json.load(open(outs["port"].replace(".json", "_benchmark.json")))[
            "speed_matched"]


def test_analysis_sweep_on_idrome_xtc_equals_jax(tmp_path):
    """`analysis_sweep` over a run directory against an IDRome-layout `.xtc`
    reference (hydrogens in `top.pdb`, cut to heavy atoms) writes JAX's
    `summary.json` and per-label files; a label without a reference gets
    the same `error` entry on both sides."""
    jax_trajio()
    ref_root = str(tmp_path / "ref")
    seqs = {"idr_a": "GSPEKQ", "idr_b": "SPQNDRG"}
    heavy = write_idrome_tree(ref_root, seqs, frames=120, seed=0)
    run_dir = tmp_path / "run"
    for i, (label, seq) in enumerate([*seqs.items(), ("idr_c", "GGSA")]):
        top, pred = _peptide_frames(seq, 70, 0.03, 10 + i)
        base = run_dir / "sampler" / label / "predicted_samples"
        base.mkdir(parents=True)
        save_pdb(str(base / "topology.pdb"), top, pred[0])
        write_dcd(str(base / "joined_trajectory.dcd"), pred)
    assert load_pdb(os.path.join(ref_root, "idr_a", "top.pdb"))[0].n_atoms > heavy["idr_a"]
    summaries = {}
    for name, mod in (("port", analysis_sweep), ("jax", j_sweep)):
        out = str(tmp_path / f"out_{name}")
        mod.main(["--run-dir", str(run_dir), "--reference-dir", ref_root, "--ref-traj-suffix",
                  "/traj.xtc", "--ref-pdb-suffix", "/top.pdb", "--out", out, "--tica-lag", "1000"])
        summaries[name] = json.load(open(os.path.join(out, "summary.json")))
        for label in seqs:
            assert json.load(open(os.path.join(out, f"{label}.json"))) == summaries[name][label]
    got, want = summaries["port"], summaries["jax"]
    assert got == want
    assert sorted(got) == ["idr_a", "idr_b", "idr_c"] and "error" in got["idr_c"]
    for label in seqs:
        assert "error" not in got[label]
        assert {"tica0_jsd", "msm_state_jsd", "torsion_jsd_mean"} <= set(got[label])
        assert got[label]["num_ref_frames"] == 120
