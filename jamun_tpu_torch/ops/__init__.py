"""The port's equivariant ops (counterpart of `jamun_tpu/ops/`).

The names `jamun_tpu.ops` exports resolve here too (so that a config target
`jamun_tpu.ops.<Name>` maps onto the port), each loaded from its module at
first use: importing one submodule does not import the others.
"""

import importlib

_EXPORTS = {
    "Conv": "conv", "ConvBlock": "conv", "SeparableConv": "conv", "ExperimentalConv": "conv",
    "Gate": "gate",
    "kabsch_align": "geometry", "mean_center": "geometry",
    "EdgeData": "graph", "GraphBatch": "graph", "dense_edge_data": "graph",
    "Irrep": "irreps", "Irreps": "irreps", "pack_irreps": "irreps", "unpack_irreps": "irreps",
    "equivariant_layer_norm": "layer_norm",
    "IrrepsLinear": "linear",
    "EquivariantMLP": "mlp", "EquivariantMLPBlock": "mlp", "ScalarMLP": "mlp",
    "soft_one_hot_linspace": "radial",
    "spherical_harmonics": "sh",
    "WeightedTensorProduct": "tensor_product", "depthwise_tp": "tensor_product",
    "fully_connected_tp": "tensor_product", "scale_irreps": "tensor_product",
    "Attention": "attention", "MultiheadAttention": "attention", "TransformerBlock": "attention",
    "split_irreps": "attention",
    "ExperimentalTensorProduct": "experimental_tp", "external_linear": "experimental_tp",
    "full_tensor_product": "experimental_tp",
    "ExtractIrreps": "extract", "ScaleIrreps": "extract", "extract_irreps": "extract",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
