"""K-means clustering and a Markov state model in numpy (the port's own copy
of `jamun_tpu/analysis/msm.py`): Lloyd's algorithm with k-means++ seeding
from `default_rng(seed)`, and a symmetrized count matrix."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["kmeans", "MSM"]


def kmeans(
    X: np.ndarray, k: int, n_iter: int = 100, seed: int = 0, tol: float = 1e-6
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm with k-means++ init. Returns (centers [k,d], labels)."""
    rng = np.random.default_rng(seed)
    n = len(X)
    centers = [X[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((X[:, None] - np.asarray(centers)[None]) ** 2).sum(-1), axis=1)
        p = d2 / d2.sum() if d2.sum() > 0 else None
        centers.append(X[rng.choice(n, p=p)])
    centers = np.asarray(centers)
    labels = np.zeros(n, int)
    for _ in range(n_iter):
        d2 = ((X[:, None] - centers[None]) ** 2).sum(-1)
        new_labels = d2.argmin(1)
        new_centers = np.stack(
            [X[new_labels == j].mean(0) if (new_labels == j).any() else centers[j] for j in range(k)]
        )
        shift = np.abs(new_centers - centers).max()
        centers, labels = new_centers, new_labels
        if shift < tol:
            break
    return centers, labels


@dataclasses.dataclass
class MSM:
    """Maximum-likelihood reversible-ish MSM from discrete trajectories."""

    lag: int = 1
    n_states: Optional[int] = None
    transition_matrix_: Optional[np.ndarray] = None
    stationary_distribution_: Optional[np.ndarray] = None

    def fit(self, dtrajs: Sequence[np.ndarray]) -> "MSM":
        dtrajs = [np.asarray(d, int) for d in dtrajs]
        k = self.n_states or (max(int(d.max()) for d in dtrajs if len(d)) + 1)
        C = np.zeros((k, k))
        for d in dtrajs:
            if len(d) > self.lag:
                np.add.at(C, (d[: -self.lag], d[self.lag :]), 1.0)
        C = C + C.T  # detailed-balance symmetrization
        rows = C.sum(1)
        rows[rows == 0] = 1.0
        T = C / rows[:, None]
        self.transition_matrix_ = T
        evals, evecs = np.linalg.eig(T.T)
        i = np.argmax(evals.real)
        pi = np.abs(evecs[:, i].real)
        self.stationary_distribution_ = pi / pi.sum()
        self.n_states = k
        return self

    def metastable_probabilities(self, n_sets: int = 2) -> np.ndarray:
        """Coarse metastable memberships via sign structure of the slowest
        left eigenvectors (simple PCCA-like split)."""
        T = self.transition_matrix_
        evals, evecs = np.linalg.eig(T)
        order = np.argsort(-evals.real)
        sign_vec = evecs[:, order[1]].real if T.shape[0] > 1 else np.zeros(1)
        membership = (sign_vec > 0).astype(int)
        probs = np.zeros(n_sets)
        for s in range(min(n_sets, 2)):
            probs[s] = self.stationary_distribution_[membership == s].sum()
        return probs
