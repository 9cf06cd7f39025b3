"""Training diagnostics: sigma against loss and gradient norm
(counterpart of `jamun_tpu/train/diagnostics.py`).

`SigmaDistributionDiagnostics` gathers (step, sigma, loss, grad_norm) at
each logged train step and writes them as a CSV per epoch, with a density
plot where matplotlib is installed, as in JAX. JAX's per-sigma denoise metrics
(`visualize_denoise_metrics`) are not ported (ROADMAP.md queue A,
'Denoise visualization').
"""

from __future__ import annotations

import csv
import importlib.util
import os
from typing import Dict, List

import numpy as np

__all__ = ["SigmaDistributionDiagnostics"]


class SigmaDistributionDiagnostics:
    """Accumulates (sigma, loss, grad_norm) per train step; writes a CSV and
    optional density plots at the end of each epoch."""

    def __init__(self, output_dir: str, plot: bool = True):
        self.output_dir = output_dir
        self.plot = plot
        self.rows: List[Dict[str, float]] = []

    def update(self, aux: Dict[str, float], step: int):
        self.rows.append(
            {
                "step": step,
                "sigma": float(aux.get("sigma", np.nan)),
                "loss": float(aux.get("loss", np.nan)),
                "grad_norm": float(aux.get("grad_norm", np.nan)),
            }
        )

    def flush(self, epoch: int):
        if not self.rows:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, f"sigma_distribution_epoch{epoch}.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["step", "sigma", "loss", "grad_norm"])
            w.writeheader()
            w.writerows(self.rows)
        if self.plot and importlib.util.find_spec("matplotlib") is not None:
            self._plot(epoch)
        self.rows = []

    def _plot(self, epoch: int) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sig = np.asarray([r["sigma"] for r in self.rows])
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for ax, key in zip(axes, ["loss", "grad_norm"]):
            val = np.asarray([r[key] for r in self.rows])
            ok = np.isfinite(sig) & np.isfinite(val) & (val > 0)
            if ok.sum() > 1:
                ax.scatter(sig[ok], val[ok], s=4, alpha=0.4)
                ax.set_yscale("log")
            ax.set_xlabel("sigma")
            ax.set_ylabel(key)
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_dir, f"sigma_distribution_epoch{epoch}.png"), dpi=100)
        plt.close(fig)

