"""Sampler parameter callbacks: change the MCMC settings between sample batches
(counterpart of `jamun_tpu/sampling/callbacks.py`). `MCMCConfig` is frozen,
so a callback returns an updated batch sampler, and `Sampler.sample` applies
it before each batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

__all__ = [
    "DeltaSqrtDecayCallback",
    "InterpolateParametersCallback",
    "MeasurementDependentParametersCallback",
]


def _update_mcmc(batch_sampler, **changes):
    new_cfg = dataclasses.replace(batch_sampler.mcmc.config, **changes)
    return dataclasses.replace(batch_sampler, mcmc=type(batch_sampler.mcmc)(new_cfg))


class DeltaSqrtDecayCallback:
    """delta_k = delta_0 / sqrt(k + 1) per sample batch."""

    def __init__(self, delta_0: float):
        self.delta_0 = delta_0

    def update_sampler(self, batch_sampler, batch_idx: int):
        return _update_mcmc(batch_sampler, delta=self.delta_0 / (batch_idx + 1) ** 0.5)


class InterpolateParametersCallback:
    """Linear interpolation of MCMC parameters over `num_batches`."""

    def __init__(self, start: Dict[str, float], end: Dict[str, float], num_batches: int):
        assert set(start) == set(end)
        self.start, self.end, self.num_batches = start, end, num_batches

    def update_sampler(self, batch_sampler, batch_idx: int):
        t = min(batch_idx / max(self.num_batches - 1, 1), 1.0)
        changes = {k: (1 - t) * self.start[k] + t * self.end[k] for k in self.start}
        return _update_mcmc(batch_sampler, **changes)


class MeasurementDependentParametersCallback:
    """A table of parameters per measurement: row k applies at batch k (the
    last row from then on); a "sigma" entry sets the sampler's noise level."""

    def __init__(self, parameters_per_measurement: Sequence[Dict[str, float]]):
        self.table = [dict(row) for row in parameters_per_measurement]

    def update_sampler(self, batch_sampler, batch_idx: int):
        changes = dict(self.table[min(batch_idx, len(self.table) - 1)])
        sigma = changes.pop("sigma", None)
        out = _update_mcmc(batch_sampler, **changes)
        if sigma is not None:
            out = dataclasses.replace(out, sigma=float(sigma))
        return out
