"""Contributed op libraries (counterpart of `jamun_tpu/ops/contrib/`):
`equifold`, EquiFold's l <= 1 modules on dense masked pairs."""

from jamun_tpu_torch.ops.contrib.equifold import (
    BesselBasis,
    Convnet,
    DTPByHead,
    Equiformer,
    RadialNN,
    SinusoidalBasis,
    SVLayerNorm,
    SVLinear,
)

__all__ = [
    "BesselBasis",
    "Convnet",
    "DTPByHead",
    "Equiformer",
    "RadialNN",
    "SinusoidalBasis",
    "SVLayerNorm",
    "SVLinear",
]
