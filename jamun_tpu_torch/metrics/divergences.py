"""Distribution distances: the histogram Jensen-Shannon divergence and the
sliced Wasserstein distance with its seeded numpy generator (counterpart of
`jamun_tpu/metrics/divergences.py`)."""

from __future__ import annotations

import numpy as np

__all__ = ["jensen_shannon_divergence", "histogram_jsd_2d", "sliced_wasserstein_distance"]


def jensen_shannon_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """JSD (natural log) between two (unnormalized) histograms."""
    p = np.asarray(p, float).ravel()
    q = np.asarray(q, float).ravel()
    p = p / max(p.sum(), eps)
    q = q / max(q.sum(), eps)
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / np.maximum(b[mask], eps))))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def histogram_jsd_2d(
    x1: np.ndarray,
    y1: np.ndarray,
    x2: np.ndarray,
    y2: np.ndarray,
    bins: int = 50,
    range_=((-np.pi, np.pi), (-np.pi, np.pi)),
) -> float:
    """JSD between 2D histograms of two samples (e.g. Ramachandran maps)."""
    h1, _, _ = np.histogram2d(x1.ravel(), y1.ravel(), bins=bins, range=range_)
    h2, _, _ = np.histogram2d(x2.ravel(), y2.ravel(), bins=bins, range=range_)
    return jensen_shannon_divergence(h1, h2)


def _wasserstein_1d(a: np.ndarray, b: np.ndarray) -> float:
    """W1 between two 1D empirical distributions (quantile-function L1)."""
    a, b = np.sort(a), np.sort(b)
    n = max(len(a), len(b))
    qs = (np.arange(n) + 0.5) / n
    av = np.quantile(a, qs, method="linear")
    bv = np.quantile(b, qs, method="linear")
    return float(np.abs(av - bv).mean())


def sliced_wasserstein_distance(
    X: np.ndarray, Y: np.ndarray, n_projections: int = 50, seed: int = 0
) -> float:
    """Monte-Carlo sliced W1 between point clouds X [n, d], Y [m, d]."""
    rng = np.random.default_rng(seed)
    d = X.shape[1]
    dirs = rng.standard_normal((n_projections, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vals = [_wasserstein_1d(X @ u, Y @ u) for u in dirs]
    return float(np.mean(vals))
