"""Training diagnostics: sigma against loss and gradient norm
(counterpart of `jamun_tpu/train/diagnostics.py`).

`SigmaDistributionDiagnostics` gathers (step, sigma, loss, grad_norm) at
each logged train step and writes them as a CSV per epoch, with a density
plot where matplotlib is installed, as in JAX. `visualize_denoise_metrics`
denoises one batch at a ladder of fixed sigmas and returns the per-sigma
metrics (JAX's `train/diagnostics.py:83-106`, the reference's
`VisualizeDenoise` without its wandb views); it needs no plotting package.
"""

from __future__ import annotations

import csv
import importlib.util
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from jamun_tpu_torch.models.denoiser import masked_graph_mean
from jamun_tpu_torch.parallel.mesh import global_graph_mean, make_generator
from jamun_tpu_torch.train.state import denoiser_on

__all__ = ["SigmaDistributionDiagnostics", "visualize_denoise_metrics"]


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



def visualize_denoise_metrics(
    denoiser,
    module: torch.nn.Module,
    batch,
    sigmas: Sequence[float] = (0.01, 0.02, 0.04, 0.08, 0.16, 0.32),
    seed: int = 0,
    mesh=None,
) -> Dict[float, Dict[str, float]]:
    """Noise `batch` at each sigma and denoise it with `module` (the EMA
    weights, in `denoiser`'s configuration, atom-sharded where it is,
    aligned as in evaluation) -> {sigma: {metric: its mean over the valid
    graphs}}. Sigma i draws its noise from a generator on the batch's device
    seeded with seed + i (JAX seeds a PRNG key the same way; the draws
    differ between the two). Over a data-parallel `mesh` the batch is this
    rank's slice and the means run over every rank's valid graphs."""
    den = denoiser_on(denoiser, module)
    out: Dict[float, Dict[str, float]] = {}
    for i, sigma in enumerate(sigmas):
        generator = make_generator(batch.pos.device, seed + i, mesh)
        with torch.no_grad():
            per_graph, aux = den.noise_and_compute_loss(
                batch, float(sigma), generator, denoiser.config.align_noisy_input_during_evaluation
            )
            if mesh is None:
                _, aux = masked_graph_mean(per_graph, aux, batch.graph_mask)
            else:
                _, aux = global_graph_mean(per_graph, aux, batch.graph_mask, mesh)
        aux.pop("loss")
        out[float(sigma)] = {k: float(v) for k, v in aux.items()}
    return out
