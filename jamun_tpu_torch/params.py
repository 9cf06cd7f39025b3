"""Parameter bridge between a flax param tree of the JAX E3Conv and the
port's `E3Conv.state_dict()`.

The torch modules carry the flax names, so the mapping is the tree path
joined with "." (e.g. `_HiddenLayer_0/ConvBlock_0/Conv_0/radial_nn/Dense_1/
kernel` -> `_HiddenLayer_0.ConvBlock_0.Conv_0.radial_nn.Dense_1.kernel`).
Orientation is kept as flax has it: a Dense `kernel` is [in, out] and the
port's `ops.mlp.Dense` computes x @ kernel + bias; IrrepsLinear kernels
`w_i_j` are [mul_in, mul_out] on both sides. Nothing is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params"]


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (optionally under "params") -> a
    state_dict of f32 tensors for `E3Conv.load_state_dict(..., strict=True)`."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, name)
            else:
                out[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: a state_dict -> {"params": nested dict of numpy arrays}."""
    tree: dict = {}
    for name, t in state_dict.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().cpu().numpy()
    return {"params": tree}
