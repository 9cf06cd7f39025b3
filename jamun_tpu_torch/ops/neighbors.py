"""Capped neighbour lists: the sparse execution path for large molecules.

Counterpart of `jamun_tpu/ops/neighbors.py:33-143` (single device; the
atom-sharded arguments are not ported, ROADMAP.md queue A, 'Parallel'). Each
destination atom keeps its K nearest sources inside the cutoff in a
[G, N, K] list (one `torch.topk` over the [G, N, N] distance panel), so the
message work is O(N K) instead of O(N^2); `overflow` counts the in-cutoff
edges the cap dropped. Only the [G, N, K] edge features are kept; the
distance panel is transient.

`torch.topk` may order tied slots differently from `lax.top_k`; the lists
agree with JAX's as sets per row, and every consumer masks and sums over K.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from jamun_tpu_torch.ops.graph import EdgeData, dense_edge_data

__all__ = ["capped_neighbor_lists", "gather_neighbors", "neighbor_edge_data"]


def gather_neighbors(x_src: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """x_src [G, N_src, D], nbr_idx [G, N, K] -> [G, N, K, D]."""
    G, N, K = nbr_idx.shape
    D = x_src.shape[-1]
    rows = torch.gather(x_src, 1, nbr_idx.reshape(G, N * K, 1).expand(-1, -1, D))
    return rows.reshape(G, N, K, D)


def capped_neighbor_lists(
    pos: torch.Tensor, node_mask: torch.Tensor, radial_cutoff, cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K = min(cap, N) nearest in-cutoff sources of every atom.

    Returns (nbr_idx [G, N, K] int64, nbr_mask [G, N, K] bool, overflow [G]
    int64: the in-cutoff edges the cap dropped, per graph). A masked slot
    holds an arbitrary index in range. The edge set is `dense_edge_data`'s:
    every pair inside the cutoff but self-pairs and padding; bonds stay a
    list of their own."""
    N = pos.shape[1]
    diff = pos[:, None, :, :] - pos[:, :, None, :]
    dist = torch.linalg.vector_norm(diff + 1e-12, dim=-1)  # [G, N, N_src]
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)[None]
    in_cut = (dist < radial_cutoff) & node_mask[:, :, None] & node_mask[:, None, :] & ~eye
    cap = min(cap, N)
    ranked = torch.where(in_cut, dist, torch.full_like(dist, float("inf")))
    neg_topk, nbr_idx = torch.topk(-ranked, cap, dim=-1)
    deg = in_cut.sum(-1)
    overflow = torch.clamp(deg - cap, min=0).sum(-1)
    return nbr_idx, torch.isfinite(neg_topk), overflow


def neighbor_edge_data(
    pos: torch.Tensor,
    node_mask: torch.Tensor,
    bond_src: torch.Tensor,
    bond_dst: torch.Tensor,
    bond_mask: torch.Tensor,
    radial_cutoff,
    sh_fn,
    attr_fn,
    cap: int,
    bond0_embed: Optional[torch.Tensor] = None,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[EdgeData, Optional[torch.Tensor]]:
    """The sparse counterpart of `dense_edge_data`: EdgeData with the
    per-neighbour fields set (features of the [G, N, K] kept edges only) and
    the dense fields None. Returns (EdgeData, overflow).

    `cache` = (nbr_idx, superset_mask): a Verlet list built within
    cutoff + skin by the walk (`sampling/mcmc.NeighborCachedScore`). The
    list build is skipped; membership comes from the cache and the
    true-cutoff mask is recomputed from the current edge lengths, so the
    edge set stays exact while the list is valid. overflow is None then
    (`Sampler` reports the cap's drops once per batch)."""
    if cache is not None:
        nbr_idx, sup_mask = cache
        overflow = None
    else:
        nbr_idx, nbr_mask, overflow = capped_neighbor_lists(pos, node_mask, radial_cutoff, cap)
    edge_vec = gather_neighbors(pos, nbr_idx) - pos[:, :, None, :]
    edge_len = torch.linalg.vector_norm(edge_vec + 1e-12, dim=-1)
    if cache is not None:
        nbr_mask = (sup_mask > 0) & (edge_len < radial_cutoff)
    edges = dense_edge_data(
        pos, node_mask, bond_src, bond_dst, bond_mask, radial_cutoff, sh_fn, attr_fn, dense=False
    )
    return dataclasses.replace(
        edges,
        nbr_idx=nbr_idx,
        nbr_mask=nbr_mask.to(pos.dtype),
        sh_nbr=sh_fn(edge_vec),
        attr_nbr=attr_fn(edge_len, bonded=False),
        bond0_embed=bond0_embed,
    ), overflow
