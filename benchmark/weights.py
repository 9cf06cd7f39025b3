"""Random weights of the E3Conv denoiser, made by the benchmark from the seed.

The published initialization (flax's, and the port's `reset_parameters`):
N(0, 1) for the embeddings and the IrrepsLinear kernels, U(+-1/sqrt(fan_in))
for the kernels and biases of the Dense layers, kernel 0 and bias 1 for the
last layer of each noise-scale predictor (the identity scaling), and
`output_gain` 0. The benchmark sets `output_gain` to 1 (the configuration
lists it under `assumed`): at 0 the network's output is multiplied away.

The numbers come from two draws on the device, one normal and one uniform,
each as long as all parameters together, sliced per parameter in the order
of `named_shapes`: a few large calls, in the type the weights are held in.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["init_kind", "make_weights"]


def init_kind(name: str) -> str:
    """"normal", "uniform", "zeros", "ones" or "gain" for a parameter name."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "output_gain":
        return "gain"
    if "_ScalePredictor_" in name and ".Dense_1." in name:
        return "zeros" if leaf == "kernel" else "ones"
    if leaf in ("kernel", "bias"):
        return "uniform"
    if leaf == "embedding" or leaf.startswith("w_") or name == "embed_bondedness":
        return "normal"
    raise ValueError(f"no initialization rule for {name}")


def make_weights(named_shapes: List[Tuple[str, tuple]], seed: int, device, output_gain: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`, a function of the seed alone."""
    shapes = dict(named_shapes)
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape in named_shapes:
        n = int(torch.Size(shape).numel())
        kind = init_kind(name)
        if kind == "normal":
            t = normal[off: off + n]
        elif kind == "uniform":
            kernel = shapes[name.rsplit(".", 1)[0] + ".kernel"]
            t = uniform[off: off + n] * float(kernel[0]) ** -0.5
        elif kind == "zeros":
            t = torch.zeros(n, device=device)
        elif kind == "ones":
            t = torch.ones(n, device=device)
        else:
            t = torch.full((n,), float(output_gain), device=device)
        out[name] = t.reshape(shape).clone()
        off += n
    return out
