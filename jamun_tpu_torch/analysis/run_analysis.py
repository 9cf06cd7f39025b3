"""Per-peptide ensemble-quality analysis (counterpart of
`jamun_tpu/analysis/run_analysis.py`): torsion featurization -> feature
histograms -> PMFs -> torsion JSD (and against the number of samples) ->
TICA -> TICA JSDs -> k-means and MSM metastable-state JSD, comparing a
sampled trajectory with reference MD. Host numpy throughout, as in JAX.

    python -m jamun_tpu_torch.analysis.run_analysis --pdb top.pdb \
        --pred samples.dcd --ref reference.npz [--out analysis_result.json]

reads `.dcd`, `.npz` (key "positions") or `.npy` trajectories, as JAX's
does. A failed TICA/MSM stage (`ValueError`, `LinAlgError`) is logged and
its keys left out, as in JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import logging
from typing import Any, Dict, List

import numpy as np

from jamun_tpu_torch.analysis.msm import MSM, kmeans
from jamun_tpu_torch.analysis.tica import TICA
from jamun_tpu_torch.data.topology import Topology
from jamun_tpu_torch.metrics.dihedrals import compute_phi_psi
from jamun_tpu_torch.metrics.divergences import histogram_jsd_2d, jensen_shannon_divergence

log = logging.getLogger("jamun_tpu_torch")

__all__ = [
    "featurize_torsions",
    "pmf_1d",
    "analyze_trajectories",
    "subset_reference_trajectory",
    "autocovariance",
]


def subset_reference_trajectory(
    pred_pos: np.ndarray,
    ref_pos: np.ndarray,
    pred_seconds_per_sample: float,
    ref_seconds_per_sample: float,
    base_factor: float = 1.0,
) -> np.ndarray:
    """Truncate the reference-MD ensemble to `base_factor` x the sampled
    trajectory's *wall-clock* budget — the paper's speed-matched comparison
    (the reference JAMUN's `analysis/run_analysis.py`): rerunning the analysis
    with this subset as the "trajectory" answers "what would MD have produced
    in the same sampling time?"."""
    pred_time = pred_seconds_per_sample * len(pred_pos)
    ref_time = ref_seconds_per_sample * len(ref_pos)
    factor = min(pred_time / ref_time, 1.0) * base_factor
    return ref_pos[: int(factor * len(ref_pos))]


def autocovariance(x: np.ndarray, nlag: int = 1000) -> np.ndarray:
    """Adjusted (unbiased), non-demeaned autocovariance of a 1-D series —
    the statsmodels `acovf(x, nlag=..., adjusted=True, demean=False)` that
    the reference JAMUN applies to the TICA-0 projection."""
    x = np.asarray(x, np.float64)
    n = len(x)
    nlag = min(nlag, n - 1)
    return np.array([np.dot(x[: n - k], x[k:]) / (n - k) for k in range(nlag + 1)])


def featurize_torsions(topology: Topology, pos: np.ndarray) -> np.ndarray:
    """[T, n_atoms, 3] -> [T, 2m] (cos/sin-safe raw angles phi ++ psi)."""
    phi, psi = compute_phi_psi(topology, pos)
    return np.concatenate([phi, psi], axis=-1)


def pmf_1d(x: np.ndarray, bins: int = 60, range_=(-np.pi, np.pi), kT: float = 1.0):
    hist, edges = np.histogram(x, bins=bins, range=range_, density=True)
    with np.errstate(divide="ignore"):
        pmf = -kT * np.log(hist)
    pmf -= np.nanmin(pmf[np.isfinite(pmf)])
    return pmf, edges


def _feature_jsds(f_pred: np.ndarray, f_ref: np.ndarray, bins: int = 50) -> List[float]:
    out = []
    for j in range(f_pred.shape[1]):
        h1, _ = np.histogram(f_pred[:, j], bins=bins, range=(-np.pi, np.pi))
        h2, _ = np.histogram(f_ref[:, j], bins=bins, range=(-np.pi, np.pi))
        out.append(jensen_shannon_divergence(h1, h2))
    return out


def analyze_trajectories(
    topology: Topology,
    pred_pos: np.ndarray,
    ref_pos: np.ndarray,
    tica_lag: int = 1000,
    n_clusters: int = 50,
    msm_lag: int = 10,
    bins: int = 50,
) -> Dict[str, Any]:
    """Full quality comparison of a sampled ensemble vs reference MD."""
    f_pred = featurize_torsions(topology, pred_pos)
    f_ref = featurize_torsions(topology, ref_pos)
    m = f_pred.shape[1] // 2
    result: Dict[str, Any] = {
        "num_pred_frames": len(f_pred),
        "num_ref_frames": len(f_ref),
        "torsion_jsds": _feature_jsds(f_pred, f_ref, bins),
    }
    result["torsion_jsd_mean"] = float(np.mean(result["torsion_jsds"])) if m else 0.0
    if m:
        result["ramachandran_jsd"] = histogram_jsd_2d(
            f_pred[:, :m], f_pred[:, m:], f_ref[:, :m], f_ref[:, m:], bins=bins
        )
        # JSD vs number of samples (convergence curve)
        curve = []
        for n in np.unique(np.geomspace(10, len(f_pred), 8).astype(int)):
            curve.append(
                (int(n), histogram_jsd_2d(f_pred[:n, :m], f_pred[:n, m:], f_ref[:, :m], f_ref[:, m:], bins=bins))
            )
        result["jsd_vs_num_samples"] = curve

    # TICA on cos/sin embedding of reference; project both
    emb_ref = np.concatenate([np.cos(f_ref), np.sin(f_ref)], axis=-1)
    emb_pred = np.concatenate([np.cos(f_pred), np.sin(f_pred)], axis=-1)
    lag = min(tica_lag, max(len(emb_ref) // 10, 1))
    try:
        tica = TICA(lag=lag, dim=4).fit([emb_ref])
        t_ref = tica.transform(emb_ref)
        t_pred = tica.transform(emb_pred)
        lo, hi = t_ref[:, 0].min(), t_ref[:, 0].max()
        h1, _ = np.histogram(t_pred[:, 0], bins=bins, range=(lo, hi))
        h2, _ = np.histogram(t_ref[:, 0], bins=bins, range=(lo, hi))
        result["tica0_jsd"] = jensen_shannon_divergence(h1, h2)
        if t_ref.shape[1] >= 2:
            r2 = ((lo, hi), (t_ref[:, 1].min(), t_ref[:, 1].max()))
            H1, _, _ = np.histogram2d(t_pred[:, 0], t_pred[:, 1], bins=bins, range=r2)
            H2, _, _ = np.histogram2d(t_ref[:, 0], t_ref[:, 1], bins=bins, range=r2)
            result["tica01_jsd"] = jensen_shannon_divergence(H1, H2)

        # KMeans + MSM metastable-state probabilities
        k = min(n_clusters, max(len(t_ref) // 10, 2))
        centers, _ = kmeans(t_ref[:, :2], k, seed=0)

        def discretize(t):
            d2 = ((t[:, None, :2] - centers[None]) ** 2).sum(-1)
            return d2.argmin(1)

        msm_ref = MSM(lag=min(msm_lag, max(len(t_ref) // 20, 1)), n_states=k).fit([discretize(t_ref)])
        probs_ref = np.zeros(k)
        np.add.at(probs_ref, discretize(t_ref), 1.0)
        probs_pred = np.zeros(k)
        np.add.at(probs_pred, discretize(t_pred), 1.0)
        result["msm_state_jsd"] = jensen_shannon_divergence(probs_pred, probs_ref)
        result["msm_stationary"] = msm_ref.stationary_distribution_.tolist()

        # autocorrelation of the slowest TICA coordinate (statsmodels' acovf
        # in the reference JAMUN)
        result["autocorrelation"] = {
            "pred": autocovariance(t_pred[:, 0]).tolist(),
            "ref": autocovariance(t_ref[:, 0]).tolist(),
        }
    except (ValueError, np.linalg.LinAlgError) as e:
        log.warning("TICA/MSM stage skipped: %s", e)
    return result


def main(argv=None):
    from jamun_tpu_torch.data.dcd import read_dcd
    from jamun_tpu_torch.data.topology import load_pdb, preprocess_topology

    parser = argparse.ArgumentParser(description="Analyze sampled vs reference trajectories")
    parser.add_argument("--pdb", required=True)
    parser.add_argument("--pred", required=True, help=".dcd/.npy predicted trajectory")
    parser.add_argument("--ref", required=True, help=".dcd/.npy/.npz reference trajectory")
    parser.add_argument("--out", default="analysis_result.json")
    parser.add_argument("--tica-lag", type=int, default=1000)
    # speed-matched comparison (as the reference JAMUN's): when
    # both rates are resolvable, the analysis is rerun with the reference
    # ensemble truncated to the sampled trajectory's wall-clock budget and
    # saved with a `_benchmark` suffix. Rates come either from sampling-times
    # CSVs (the sample CLI writes ours) or direct values.
    parser.add_argument("--sampling-times-csv", default=None,
                        help="CSV written by the sample CLI (label,time_per_sample_seconds)")
    parser.add_argument("--label", default=None, help="predicted-trajectory label in the CSV")
    parser.add_argument("--ref-sampling-times-csv", default=None)
    parser.add_argument("--ref-label", default=None)
    parser.add_argument("--pred-seconds-per-sample", type=float, default=None)
    parser.add_argument("--ref-seconds-per-sample", type=float, default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    top_full, pos0 = load_pdb(args.pdb)
    template, top, _ = preprocess_topology(top_full, pos0[0] if len(pos0) else None)

    def load(path):
        if path.endswith(".dcd"):
            return read_dcd(path)
        if path.endswith(".npz"):
            return np.load(path)["positions"]
        return np.load(path)

    pred, ref = load(args.pred), load(args.ref)
    heavy = np.asarray(top_full.select_protein_heavy())
    if ref.shape[1] == top_full.n_atoms:
        ref = ref[:, heavy]
    result = analyze_trajectories(top, pred, ref, tica_lag=args.tica_lag)

    def save(res, path):
        with open(path, "w") as f:
            json.dump({k: v for k, v in res.items() if not isinstance(v, np.ndarray)}, f, indent=2, default=float)
        log.info("wrote %s", path)

    save(result, args.out)

    pred_rate, ref_rate = args.pred_seconds_per_sample, args.ref_seconds_per_sample
    if pred_rate is None and args.sampling_times_csv and args.label:
        from jamun_tpu_torch.analysis.load_trajectory import get_sampling_rate

        pred_rate = get_sampling_rate(args.sampling_times_csv, args.label)
    if ref_rate is None and args.ref_sampling_times_csv and args.ref_label:
        from jamun_tpu_torch.analysis.load_trajectory import get_sampling_rate

        ref_rate = get_sampling_rate(args.ref_sampling_times_csv, args.ref_label)

    if pred_rate is not None and ref_rate is not None:
        log.info("speed-matched rerun: pred %.3g s/sample vs ref %.3g s/sample", pred_rate, ref_rate)
        ref_subset = subset_reference_trajectory(pred, ref, pred_rate, ref_rate)
        base, ext = os.path.splitext(args.out)
        if len(ref_subset) >= len(ref):
            # factor saturated at 1.0: the sampled wall-clock budget covers
            # the ENTIRE reference ensemble, so the "speed-matched" rerun
            # would compare the full reference against itself (every JSD
            # exactly 0 — an information-free artifact). Record
            # the saturation explicitly instead.
            log.warning(
                "speed-matched budget saturates the reference (%d frames >= "
                "%d available); skipping the degenerate benchmark rerun",
                len(ref_subset), len(ref),
            )
            save(
                {"speed_matched": {
                    "pred_seconds_per_sample": pred_rate,
                    "ref_seconds_per_sample": ref_rate,
                    "ref_subset_frames": len(ref_subset),
                    "ref_total_frames": len(ref),
                    "skipped": "budget saturated: subset == full reference "
                    "(all JSDs would be trivially 0)",
                }},
                f"{base}_benchmark{ext or '.json'}",
            )
        elif len(ref_subset) < 2:
            # the matched wall-clock budget rounded to <2 reference frames —
            # histograms/TICA on an empty array would emit NaN JSDs; record
            # the degenerate budget explicitly instead of a NaN-filled JSON
            log.warning(
                "speed-matched budget covers %d reference frame(s); "
                "skipping the benchmark rerun", len(ref_subset),
            )
            save(
                {"speed_matched": {
                    "pred_seconds_per_sample": pred_rate,
                    "ref_seconds_per_sample": ref_rate,
                    "ref_subset_frames": len(ref_subset),
                    "skipped": "matched budget < 2 reference frames",
                }},
                f"{base}_benchmark{ext or '.json'}",
            )
        else:
            bench = analyze_trajectories(top, ref_subset, ref, tica_lag=args.tica_lag)
            bench["speed_matched"] = {
                "pred_seconds_per_sample": pred_rate,
                "ref_seconds_per_sample": ref_rate,
                "ref_subset_frames": len(ref_subset),
            }
            save(bench, f"{base}_benchmark{ext or '.json'}")


if __name__ == "__main__":
    main()
