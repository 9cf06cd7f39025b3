"""Time-lagged independent component analysis (TICA) in numpy (the port's
own copy of `jamun_tpu/analysis/tica.py`): the reversible estimate, solved
by whitening the instantaneous covariance."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["TICA"]


@dataclasses.dataclass
class TICA:
    lag: int = 1000
    dim: Optional[int] = None
    epsilon: float = 1e-6
    # fitted state
    mean_: Optional[np.ndarray] = None
    eigenvalues_: Optional[np.ndarray] = None
    eigenvectors_: Optional[np.ndarray] = None

    def fit(self, trajs: Sequence[np.ndarray]) -> "TICA":
        """trajs: list of [T_i, d] feature trajectories."""
        trajs = [np.asarray(t, float) for t in trajs if len(t) > self.lag]
        if not trajs:
            raise ValueError(f"no trajectory longer than lag={self.lag}")
        d = trajs[0].shape[1]
        n = sum(len(t) - self.lag for t in trajs)
        mean = sum(t[: -self.lag].sum(0) + t[self.lag :].sum(0) for t in trajs) / (2 * n)
        self.mean_ = mean

        C0 = np.zeros((d, d))
        Ct = np.zeros((d, d))
        for t in trajs:
            a = t[: -self.lag] - mean
            b = t[self.lag :] - mean
            C0 += a.T @ a + b.T @ b
            Ct += a.T @ b
        C0 /= 2 * n
        Ct = (Ct + Ct.T) / (2 * n)  # symmetrized (reversible estimate)

        # solve generalized eigenproblem Ct v = lambda C0 v via whitening
        evals0, evecs0 = np.linalg.eigh(C0)
        keep = evals0 > self.epsilon * evals0.max()
        W = evecs0[:, keep] / np.sqrt(evals0[keep])
        M = W.T @ Ct @ W
        evals, evecs = np.linalg.eigh(M)
        order = np.argsort(evals)[::-1]
        evals, evecs = evals[order], evecs[:, order]
        if self.dim:
            evals, evecs = evals[: self.dim], evecs[:, : self.dim]
        self.eigenvalues_ = evals
        self.eigenvectors_ = W @ evecs
        return self

    def transform(self, traj: np.ndarray) -> np.ndarray:
        return (np.asarray(traj, float) - self.mean_) @ self.eigenvectors_

    def timescales(self) -> np.ndarray:
        ev = np.clip(np.abs(self.eigenvalues_), 1e-12, 1 - 1e-12)
        return -self.lag / np.log(ev)
