"""The reference's denoiser: JAMUN's EDM preconditioning around the network,
its score and its training loss (a plain copy of the port's
`models/denoiser.py` arithmetic; Kabsch by SVD, as JAX's and the port's CPU
path compute it).

  A = average_squared_distance, B = 2 D sigma^2
  c_in = 1/sqrt(A+B), c_skip = A/(A+B), c_out = sqrt(A B/(A+B)), c_noise = log(sigma)/4
  cutoff = sqrt(max_radius^2 + 6 sigma^2) / c_in on c_in-scaled positions
  xhat = c_skip y + c_out g(c_in y), both sides mean-centred
  score = (xhat - y) / sigma^2
  loss = mean over graphs of [mean over atoms of |xhat - x|^2] / c_out^2
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from benchmark.reference.model import E3Conv, irreps_to_vector

__all__ = ["factors", "mean_center", "kabsch_align", "xhat", "score", "chunks", "per_graph_loss"]


def factors(sigma: float, average_squared_distance: float, D: int = 3):
    A, B = float(average_squared_distance), 2.0 * D * float(sigma) ** 2
    return 1.0 / math.sqrt(A + B), A / (A + B), math.sqrt(A * B / (A + B)), math.log(float(sigma)) / 4.0


def mean_center(pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].to(pos.dtype)
    mean = (pos * m).sum(1, keepdim=True) / torch.clamp(m.sum(1, keepdim=True), min=1.0)
    return (pos - mean) * m


def kabsch_align(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each graph of y rotated and moved onto x (least squares, no reflection)."""
    m = mask[..., None].to(y.dtype)
    count = torch.clamp(m.sum(1, keepdim=True), min=1.0)
    x_mu, y_mu = (x * m).sum(1, keepdim=True) / count, (y * m).sum(1, keepdim=True) / count
    H = torch.einsum("gni,gnj->gij", (y - y_mu) * m, (x - x_mu) * m)
    U, _, Vh = torch.linalg.svd(H)
    det = torch.linalg.det(torch.einsum("gki,gjk->gij", Vh, U))
    signs = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("gki,gk,gjk->gij", Vh, signs, U)
    Ry = torch.einsum("gij,gnj->gni", R, y)
    t = x_mu - torch.einsum("gij,gnj->gni", R, y_mu)
    return (Ry + t) * m


def xhat(net: E3Conv, b: Dict[str, torch.Tensor], y: torch.Tensor, sigma: float, config: dict):
    """The denoised positions of y [G, N, 3] (f32)."""
    mask = b["node_mask"]
    c_in, c_skip, c_out, c_noise = factors(sigma, config["average_squared_distance"])
    cutoff = math.sqrt(config["max_radius"] ** 2 + 6.0 * sigma**2) / c_in
    y = mean_center(y, mask)
    c = torch.full((1,), c_noise, dtype=torch.float32, device=y.device)
    g = net(b, y * c_in, c, cutoff)
    return mean_center(c_skip * y + c_out * irreps_to_vector(g), mask)


def score(net: E3Conv, b: Dict[str, torch.Tensor], y: torch.Tensor, sigma: float, config: dict):
    return (xhat(net, b, y, sigma, config) - y) / float(sigma) ** 2


def chunks(b: Dict[str, torch.Tensor], size: int) -> Iterator[Tuple[slice, Dict[str, torch.Tensor]]]:
    """The batch in blocks of `size` graphs, so that the reference's dense
    [G, N, N, *] tensors fit beside what is left on the card."""
    G = b["pos"].shape[0]
    for g0 in range(0, G, size):
        sl = slice(g0, min(g0 + size, G))
        yield sl, {k: v[sl] for k, v in b.items()}


def per_graph_loss(xhat_pos: torch.Tensor, x: torch.Tensor, b: Dict[str, torch.Tensor], sigma: float,
                   config: dict) -> torch.Tensor:
    """[G]: mean over atoms of |xhat - x|^2, times the graph's loss weight, over c_out^2."""
    m = b["node_mask"].to(x.dtype)
    per_atom = ((xhat_pos - mean_center(x, b["node_mask"])) ** 2).sum(-1) * m
    raw = per_atom.sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    c_out = factors(sigma, config["average_squared_distance"])[2]
    return raw * b["loss_weight"] / c_out**2
