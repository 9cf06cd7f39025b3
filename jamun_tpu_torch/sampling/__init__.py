"""Sampling: BAOAB and ABOBA walks, walk-jump, the Sampler and its callbacks
(counterpart of `jamun_tpu/sampling/`; VESDE and UnrolledBAOAB are not
ported)."""

from jamun_tpu_torch.sampling.mcmc import (
    ABOBA,
    BAOAB,
    MCMCConfig,
    initialize_velocity,
    make_processed_score_fn,
)
from jamun_tpu_torch.sampling.sampler import Sampler, unbatch_samples
from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
