"""Sampling: BAOAB and ABOBA walks (also in chunks, `UnrolledBAOAB`),
walk-jump, the VE-SDE reverse diffusion, the Sampler and its callbacks
(counterpart of `jamun_tpu/sampling/`)."""

from jamun_tpu_torch.sampling.mcmc import (
    ABOBA,
    BAOAB,
    MCMCConfig,
    initialize_velocity,
    make_processed_score_fn,
)
from jamun_tpu_torch.sampling.sampler import Sampler, unbatch_samples
from jamun_tpu_torch.sampling.unrolled import UnrolledBAOAB
from jamun_tpu_torch.sampling.vesde import VESDEReverseDiffusionSampler
from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
