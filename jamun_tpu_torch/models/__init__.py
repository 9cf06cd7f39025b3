"""Models: E3Conv, its embeddings and noise conditioning, and the Denoiser
(counterpart of `jamun_tpu/models/`; Ophiuchus and the other embeddings are
not ported)."""

from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
from jamun_tpu_torch.models.e3conv import E3Conv, irreps_to_vector
