"""Closed-form l <= 1 depthwise ("uvu") tensor-product messages.

Counterpart of `jamun_tpu/ops/fast_uvu.py`. For node features
x = [s (S x 0e) | v (V x 1e, components y, z, x)], edge SH
[1 | sh (y, z, x)] and per-edge weights w = [w1 (S) | w2 (S) | w3 (V) |
w4 (V) | w5 (V)] the message blocks are, in `depthwise_tp` order
[S x 0e, S x 1e, V x 1e, V x 0e, V x 1e]:

    w1 s,  w2 s sh,  w3 v,  w4 (v . sh) / sqrt(3),  w5 (v x sh) / sqrt(2)

with the cross product taken in the cyclic (y, z, x) basis.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from jamun_tpu_torch.ops.neighbors import gather_neighbors

__all__ = ["uvu_messages", "fast_uvu_messages_dense", "fast_uvu_messages_nbr"]

_INV_SQRT3 = 1.0 / math.sqrt(3.0)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def uvu_messages(
    x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor, S: int, V: int
) -> torch.Tensor:
    """Per-edge messages. x [..., S + 3V] (source features), sh [..., 4],
    w [..., 2S + 3V] -> [..., 4S + 7V] (or [..., 4S] when V == 0)."""
    dt = w.dtype
    s = x[..., :S].to(dt)
    shv = sh[..., 1:4].to(dt)  # (y, z, x)
    w1, w2 = w[..., :S], w[..., S : 2 * S]
    t2 = (w2 * s)[..., None] * shv[..., None, :]  # [..., S, 3]
    parts = [w1 * s, t2.flatten(-2)]
    if V:
        v = x[..., S:].reshape(x.shape[:-1] + (V, 3)).to(dt)
        w3 = w[..., 2 * S : 2 * S + V, None]
        w4 = w[..., 2 * S + V : 2 * S + 2 * V]
        w5 = w[..., 2 * S + 2 * V : 2 * S + 3 * V, None]
        sh3 = shv[..., None, :]
        dot = (v * sh3).sum(-1)
        vy, vz, vx = v.unbind(-1)
        sy, sz, sx = shv[..., None, 0], shv[..., None, 1], shv[..., None, 2]
        cross = torch.stack([vz * sx - vx * sz, vx * sy - vy * sx, vy * sz - vz * sy], dim=-1)
        parts += [(w3 * v).flatten(-2), w4 * dot * _INV_SQRT3, (w5 * cross * _INV_SQRT2).flatten(-2)]
    return torch.cat(parts, dim=-1)


def fast_uvu_messages_dense(
    x: torch.Tensor,  # [G, N, S + 3V]
    sh_dense: torch.Tensor,  # [G, N, N, 4] (dst, src)
    weights: torch.Tensor,  # [G, N, N, 2S + 3V]
    adj: torch.Tensor,  # [G, N, N]
    S: int,
    V: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Messages summed over sources [G, N, 4S + 7V] and the degree [G, N]."""
    msg = uvu_messages(x[:, None], sh_dense, weights, S, V)
    adj = adj.to(weights.dtype)
    return (msg * adj[..., None]).sum(dim=2), adj.sum(dim=-1)


def fast_uvu_messages_nbr(
    x: torch.Tensor,  # [G, N_src, S + 3V]
    sh_nbr: torch.Tensor,  # [G, N, K, 4]
    weights: torch.Tensor,  # [G, N, K, 2S + 3V]
    nbr_idx: torch.Tensor,  # [G, N, K] -> source index
    nbr_mask: torch.Tensor,  # [G, N, K]
    S: int,
    V: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparse counterpart of `fast_uvu_messages_dense` (JAX's
    `fast_uvu_messages_nbr`): the source axis is the gathered K-neighbour
    axis of `ops/neighbors.py`. Returns the masked sums [G, N, 4S + 7V] and
    the degree [G, N]; differentiable (the gather's backward is a
    scatter-add over the N K rows)."""
    msg = uvu_messages(gather_neighbors(x, nbr_idx), sh_nbr, weights, S, V)
    m = nbr_mask.to(weights.dtype)
    return (msg * m[..., None]).sum(dim=2), m.sum(dim=-1)
