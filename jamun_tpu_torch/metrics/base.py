"""Per-dataset trajectory metrics and the sampler callbacks that feed them
(counterpart of `jamun_tpu/metrics/base.py`).

A metric accumulates the sampled chains of one dataset ([atoms, frames, 3]
per chain, host numpy after `unbatch_samples`) and computes at the end;
`TrajectoryMetricCallback` routes each sampled graph to its dataset's
metric; `MeasureSamplingTimeCallback` turns the sampler's per-batch wall
clock into seconds per sample.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger("jamun_tpu_torch")

__all__ = ["TrajectoryMetric", "TrajectoryMetricCallback", "MeasureSamplingTimeCallback"]


class TrajectoryMetric:
    """Accumulates sampled trajectories ([atoms, frames, 3] per chain) for one
    dataset; subclasses implement `compute()`."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.template = dataset.template
        self.chains: List[np.ndarray] = []  # each [atoms, frames, 3]

    def validate(self, sample: Dict[str, Any]):
        n = self.template.num_atoms
        if sample.get("num_atoms", n) != n:
            raise ValueError(
                f"sample atom count {sample.get('num_atoms')} != dataset {n} "
                f"for {self.dataset.label()}"
            )

    def update(self, sample: Dict[str, Any]):
        self.validate(sample)
        traj = sample.get("xhat_traj")
        if traj is not None:
            self.chains.append(np.asarray(traj))

    @property
    def joined_positions(self) -> np.ndarray:
        """All frames of all chains concatenated: [total_frames, atoms, 3]."""
        if not self.chains:
            return np.zeros((0, self.template.num_atoms, 3), np.float32)
        return np.concatenate([np.transpose(c, (1, 0, 2)) for c in self.chains], axis=0)

    def compute(self) -> Dict[str, Any]:
        return {"num_chains": len(self.chains), "num_frames": int(self.joined_positions.shape[0])}

    def reset(self):
        self.chains = []


class TrajectoryMetricCallback:
    """Sampler callback: routes each sampled graph to its dataset's metric by
    graph index and computes and logs every metric at the end."""

    def __init__(self, metrics: Sequence[TrajectoryMetric], datasets_per_graph: Optional[Sequence[int]] = None):
        self.metrics = list(metrics)
        self.datasets_per_graph = datasets_per_graph
        self.results: Dict[str, Dict[str, Any]] = {}

    def _metric_for(self, sample: Dict[str, Any]) -> Optional[TrajectoryMetric]:
        g = sample.get("graph_index", 0)
        if self.datasets_per_graph is not None:
            idx = self.datasets_per_graph[g]
        else:
            idx = g % len(self.metrics) if self.metrics else 0
        return self.metrics[idx] if self.metrics else None

    def on_after_sample_batch(self, sample: List[Dict[str, Any]], sampler, **kwargs):
        for s in sample:
            m = self._metric_for(s)
            if m is not None:
                m.update(s)

    def on_sample_end(self, sampler, **kwargs):
        for m in self.metrics:
            label = m.dataset.label()
            self.results[label] = m.compute()
            log.info("metrics[%s]: %s", label, _summarize(self.results[label]))


def _summarize(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in d.items() if isinstance(v, (int, float, str))}


class MeasureSamplingTimeCallback:
    """Per-batch and cumulative time per sample, from the `elapsed_seconds`
    that `Sampler.sample` measures around each batch's walk (synchronised
    with the card).

    `label_for_graph` (graph_index -> dataset label) gives per-label rates.
    All labels of a batch walk together in one program, so each batch's wall
    clock is shared among its labels by their sample counts.

    The first batch carries the kernels' build and the first launches, so
    `rates()` leaves batch 0 out whenever two or more batches ran (the warm
    rate); the rate over all batches stands beside it as
    `time_per_sample_seconds_incl_compile`, JAX's column name.
    """

    def __init__(self, label_for_graph: Optional[Sequence[str]] = None):
        self.label_for_graph = label_for_graph
        self.total_seconds = 0.0
        self.total_samples = 0
        self.per_batch: List[Dict[str, float]] = []
        self.label_samples: Dict[str, int] = {}  # all batches
        self.label_samples_warm: Dict[str, int] = {}  # batches > 0
        self.warm_seconds = 0.0
        self.warm_samples = 0
        self.last_neighbor_overflow: Optional[Dict[str, float]] = None

    def _label(self, s) -> str:
        g = s.get("graph_index", 0)
        if self.label_for_graph is not None and g < len(self.label_for_graph):
            return str(self.label_for_graph[g])
        return "all"

    def on_after_sample_batch(
        self, sample, sampler, elapsed_seconds: float = 0.0,
        neighbor_overflow: Optional[Dict[str, float]] = None, **kwargs,
    ):
        first = not self.per_batch
        n_samples = 0
        for s in sample:
            k = s.get("xhat_traj", np.zeros((0, 0))).shape[1]
            n_samples += k
            lbl = self._label(s)
            self.label_samples[lbl] = self.label_samples.get(lbl, 0) + k
            if not first:
                self.label_samples_warm[lbl] = self.label_samples_warm.get(lbl, 0) + k
        self.total_seconds += elapsed_seconds
        self.total_samples += n_samples
        if not first:
            self.warm_seconds += elapsed_seconds
            self.warm_samples += n_samples
        entry = {
            "batch_seconds": elapsed_seconds,
            "batch_samples": n_samples,
            "ms_per_sample": 1e3 * elapsed_seconds / max(n_samples, 1),
            "cumulative_ms_per_sample": 1e3 * self.total_seconds / max(self.total_samples, 1),
        }
        if neighbor_overflow is not None:
            entry["neighbor_overflow_mean"] = neighbor_overflow.get("mean", 0.0)
            entry["neighbor_overflow_max"] = neighbor_overflow.get("max", 0)
            self.last_neighbor_overflow = dict(neighbor_overflow)
        self.per_batch.append(entry)
        log.info("sampling time: %s", {k: round(v, 4) for k, v in entry.items()})

    def rates(self) -> Dict[str, Dict[str, float]]:
        """label -> {"time_per_sample_seconds" (warm), "..._incl_compile",
        "samples"}. Every sample of a pool costs the same share of the wall
        clock (the labels walk together), so each label's rate is the
        pooled rate; the per-label sample counts make the pooling explicit."""
        use_warm = self.warm_samples > 0
        pool_secs = self.warm_seconds if use_warm else self.total_seconds
        pool_n = self.warm_samples if use_warm else self.total_samples
        warm_rate = pool_secs / max(pool_n, 1)
        out: Dict[str, Dict[str, float]] = {}
        for lbl, n_all in self.label_samples.items():
            out[lbl] = {
                "time_per_sample_seconds": warm_rate,
                "time_per_sample_seconds_incl_compile": self.total_seconds
                / max(self.total_samples, 1),
                "samples": n_all,
            }
        return out
