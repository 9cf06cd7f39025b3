"""Models: E3Conv and Ophiuchus, the atom embedders, noise conditioning and
the Denoiser (counterpart of `jamun_tpu/models/`)."""

from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
from jamun_tpu_torch.models.e3conv import E3Conv, irreps_to_vector, vector_to_irreps
from jamun_tpu_torch.models.embeddings import (
    AtomEmbeddingWithResidueInformation,
    CoarseGrainedBeadEmbedding,
    SimpleAtomEmbedding,
)
from jamun_tpu_torch.models.noise_conditioning import (
    NoiseConditionalScaling,
    NoiseConditionalSkipConnection,
)
from jamun_tpu_torch.models.ophiuchus import Ophiuchus, tensor_square
