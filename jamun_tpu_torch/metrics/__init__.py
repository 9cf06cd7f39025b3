"""Sampling metrics: host-side numpy on the per-graph dicts that
`sampling.sampler.unbatch_samples` makes (counterpart of
`jamun_tpu/metrics/`, with the same exports)."""

from jamun_tpu_torch.metrics.base import (
    MeasureSamplingTimeCallback,
    TrajectoryMetric,
    TrajectoryMetricCallback,
)
from jamun_tpu_torch.metrics.chemical_validity import ChemicalValidityMetrics
from jamun_tpu_torch.metrics.dihedrals import compute_phi_psi, dihedral_angles, phi_psi_indices
from jamun_tpu_torch.metrics.divergences import (
    histogram_jsd_2d,
    jensen_shannon_divergence,
    sliced_wasserstein_distance,
)
from jamun_tpu_torch.metrics.ramachandran import RamachandranMetrics
from jamun_tpu_torch.metrics.save_trajectory import SaveTrajectory
from jamun_tpu_torch.metrics.score_distribution import ScoreDistributionMetrics
from jamun_tpu_torch.metrics.visualize import SampleVisualizer, TrajectoryVisualizer
from jamun_tpu_torch.metrics.posebusters import PoseBustersMetrics
