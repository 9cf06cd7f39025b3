"""Padded batch and edge containers (counterpart of `jamun_tpu/ops/graph.py`).

Graphs are padded to [G, N] dense tensors. The radial edge set is a masked
N x N distance test recomputed from positions on every forward, or, on the
sparse path, a capped list of K neighbours per atom (`ops/neighbors.py`);
bonded edges are a small padded edge list [G, B]. `live_pairs` compacts
either radial layout to the list of its live slots, for the products that
compute a message per pair (`ops/conv.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from jamun_tpu_torch.utils.trace import span

__all__ = [
    "GraphBatch", "EdgeData", "LivePairs", "PAIR_COUNTS", "dense_edge_data", "edge_pairs",
    "live_pairs", "self_pairs",
]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A batch of G graphs padded to N nodes and B directed bonds (both
    directions present). Index tensors are int64, masks are bool."""

    pos: torch.Tensor  # [G, N, 3] float
    node_mask: torch.Tensor  # [G, N]
    atom_type_index: torch.Tensor  # [G, N]
    atom_code_index: torch.Tensor  # [G, N]
    residue_code_index: torch.Tensor  # [G, N]
    residue_sequence_index: torch.Tensor  # [G, N]
    bond_src: torch.Tensor  # [G, B]
    bond_dst: torch.Tensor  # [G, B]
    bond_mask: torch.Tensor  # [G, B]
    loss_weight: torch.Tensor  # [G]
    graph_mask: torch.Tensor  # [G]
    # the residue layout (`jamun_tpu/ops/graph.py:44-51`), which Ophiuchus
    # reads: atoms grouped by residue in a [G, R, P] gather map (P the most
    # atoms of a residue), built by `data/batching.collate`; None otherwise
    residue_atom_index: Optional[torch.Tensor] = None  # [G, R, P] index into N (0 if padded)
    residue_atom_mask: Optional[torch.Tensor] = None  # [G, R, P]
    residue_ca_index: Optional[torch.Tensor] = None  # [G, R] index of the CA atom
    residue_mask: Optional[torch.Tensor] = None  # [G, R]
    residue_codes: Optional[torch.Tensor] = None  # [G, R]

    def replace_pos(self, pos: torch.Tensor) -> "GraphBatch":
        return dataclasses.replace(self, pos=pos)

    def map(self, fn) -> "GraphBatch":
        """fn applied to every tensor field; None fields stay None."""
        return GraphBatch(**{
            f.name: None if t is None else fn(t)
            for f in dataclasses.fields(self)
            for t in (getattr(self, f.name),)
        })

    def to(self, device) -> "GraphBatch":
        return self.map(lambda t: t.to(device))

    def to_device(self, device) -> "GraphBatch":
        """The batch on `device`. A host batch bound for the card goes through
        page-locked memory with `non_blocking=True`: a copy from pageable
        memory would make the host wait for every kernel queued before it
        (the JAX loop's jitted step never waits on its input)."""
        device = torch.device(device)
        pin = device.type == "cuda" and self.pos.device.type == "cpu"
        return self.map(lambda t: (t.pin_memory() if pin else t).to(device, non_blocking=pin))


@dataclasses.dataclass(frozen=True)
class EdgeData:
    """Edge features shared by all conv layers of one forward (plain path).
    The dense fields are None on the sparse path, which fills the per-
    neighbour fields instead (`jamun_tpu/ops/graph.py:98-104`). The raw
    fields (`pos`, `node_mask`, `radial_cutoff`, the bondedness rows) are
    what `Conv`'s dense kernels read (`jamun_tpu/ops/graph.py:84-89`), and
    `pair_features` K1's edge features when the caller computed them once
    for every layer (JAX's `ef_packed` / `bf_packed`)."""

    sh_dense: Optional[torch.Tensor]  # [G, N, N, 4] (dst, src)
    attr_dense: Optional[torch.Tensor]  # [G, N, N, A]
    adj: Optional[torch.Tensor]  # [G, N, N] float; adj[g, i, j] = 1 for an edge src j -> dst i
    sh_bond: torch.Tensor  # [G, B, 4]
    attr_bond: torch.Tensor  # [G, B, A]
    bond_src: torch.Tensor  # [G, B]
    bond_dst: torch.Tensor  # [G, B]
    bond_mask: torch.Tensor  # [G, B] float
    # the sparse capped-neighbour path: slot k of dst atom i holds source
    # nbr_idx[g, i, k] when nbr_mask[g, i, k] is 1
    nbr_idx: Optional[torch.Tensor] = None  # [G, N, K] int64
    nbr_mask: Optional[torch.Tensor] = None  # [G, N, K] float
    sh_nbr: Optional[torch.Tensor] = None  # [G, N, K, 4]
    attr_nbr: Optional[torch.Tensor] = None  # [G, N, K, A], or the radial half only
    bond0_embed: Optional[torch.Tensor] = None  # [A // 2] bondedness-0 row (folded with a radial-only attr)
    # raw inputs of the dense kernels
    pos: Optional[torch.Tensor] = None  # [G, N, 3]
    node_mask: Optional[torch.Tensor] = None  # [G, N] bool
    radial_cutoff: Optional[float] = None
    bond1_embed: Optional[torch.Tensor] = None  # [A // 2] bondedness-1 row
    pair_features: Optional[tuple] = None  # (ef, bf) of `ops/cuda/edge_features`
    # the atom-sharded mode: the process group over which `Conv` gathers its
    # source features (the halo); the destination rows are this rank's
    atom_axis: Optional[object] = None
    # the live radial pairs (`edge_pairs`), when the caller compacted them
    # once for every layer
    pairs: Optional["LivePairs"] = None


@dataclasses.dataclass(frozen=True)
class LivePairs:
    """The P live slots of a radial layout, dst-major (`live_pairs`), and
    the edge features at them (`edge_pairs`)."""

    slot: torch.Tensor  # [P] int64, flat index into the [G, N, N_src] or [G, N, K] slots
    dst: torch.Tensor  # [P] int64, the destination row g * N + i, ascending
    src: torch.Tensor  # [P] int64, the source row g * N_src + j
    rows: torch.Tensor  # [G * N] int64, live slots per destination row
    count: int  # P
    sh: Optional[torch.Tensor] = None  # [P, 4]
    attr: Optional[torch.Tensor] = None  # [P, A]


class PairCounts:
    """Cumulative host counts of `live_pairs`: the live pairs found and the
    slots they were found among (live / slots is the share of the dense
    work that the compact messages do)."""

    def __init__(self):
        self.live = 0
        self.slots = 0


PAIR_COUNTS = PairCounts()


def live_pairs(
    mask: torch.Tensor, nbr_idx: Optional[torch.Tensor] = None, n_src: Optional[int] = None
) -> LivePairs:
    """The live slots of the dense `adj` [G, N, N_src] or of the sparse
    `nbr_mask` [G, N, K] with its `nbr_idx` (sources among `n_src` rows a
    graph, N by default), in dst-major order. Their number sizes what
    follows, so the host waits here for the device, once (the span
    `jamun.host.wait:pair_compact`)."""
    G, N, K = mask.shape
    with span("jamun.host.wait:pair_compact"):
        slot = torch.nonzero(mask.reshape(-1)).squeeze(1)
    P = slot.shape[0]
    PAIR_COUNTS.live += P
    PAIR_COUNTS.slots += mask.numel()
    dst = slot // K
    graph = dst // N
    if nbr_idx is None:
        src = graph * K + slot % K
    else:
        src = graph * (N if n_src is None else n_src) + nbr_idx.reshape(-1)[slot]
    rows = (mask.reshape(G * N, K) != 0).sum(-1)
    return LivePairs(slot=slot, dst=dst, src=src, rows=rows, count=P)


def edge_pairs(edges: EdgeData, n_src: Optional[int] = None) -> LivePairs:
    """`live_pairs` of the radial layout `edges` holds, with its harmonics
    and attributes gathered at the live slots; `n_src` as there (the sparse
    layout's source rows a graph)."""
    if edges.nbr_idx is None:
        pairs, sh, attr = live_pairs(edges.adj), edges.sh_dense, edges.attr_dense
    else:
        pairs = live_pairs(edges.nbr_mask, edges.nbr_idx, n_src)
        sh, attr = edges.sh_nbr, edges.attr_nbr
    return dataclasses.replace(
        pairs, sh=sh.reshape(-1, sh.shape[-1])[pairs.slot],
        attr=attr.reshape(-1, attr.shape[-1])[pairs.slot],
    )


def self_pairs(pos: torch.Tensor, src_pos: torch.Tensor, dst_index: Optional[torch.Tensor]):
    """[G or 1, N, N_src] bool: the pair of a destination row with itself
    (`dst_index` gives the rows' global indices in the atom-sharded mode)."""
    N, N_src = pos.shape[1], src_pos.shape[1]
    if dst_index is None:
        return torch.eye(N, N_src, dtype=torch.bool, device=pos.device)[None]
    return dst_index[:, :, None] == torch.arange(N_src, device=pos.device)[None, None, :]


def dense_edge_data(
    pos: torch.Tensor,
    node_mask: torch.Tensor,
    bond_src: torch.Tensor,
    bond_dst: torch.Tensor,
    bond_mask: torch.Tensor,
    radial_cutoff,
    sh_fn,
    attr_fn,
    dense: bool = True,
    bond0_embed: Optional[torch.Tensor] = None,
    bond1_embed: Optional[torch.Tensor] = None,
    src_pos: Optional[torch.Tensor] = None,
    src_mask: Optional[torch.Tensor] = None,
    dst_index: Optional[torch.Tensor] = None,
) -> EdgeData:
    """Build EdgeData from positions (the bonds alone with `dense=False`),
    with the raw fields the dense kernels read.

    sh_fn(edge_vec [..., 3]) -> [..., 4]; attr_fn(edge_len [...], bonded) -> [..., A].
    The radial edge set (bondedness 0) is the distance-cutoff graph over all
    pairs, bonded ones included, with the self-pair masked out; bonds are an
    additional edge set (bondedness 1), so a bonded pair in cutoff contributes
    two messages. Edge vector = pos[src] - pos[dst].

    The atom-sharded mode (`jamun_tpu/ops/graph.py:134-139`): `pos` and
    `node_mask` hold this rank's destination rows, `src_pos` / `src_mask`
    the whole gathered molecule, `dst_index` [G, N] the global index of
    each destination row (for the self-pair); `bond_src` indexes the
    sources, `bond_dst` the local rows.
    """
    sh_dense = attr_dense = adj = None
    if src_pos is None:
        src_pos, src_mask = pos, node_mask
    if dense:
        edge_vec = src_pos[:, None, :, :] - pos[:, :, None, :]  # [g, i(dst), j(src)]
        dist = torch.linalg.vector_norm(edge_vec + 1e-12, dim=-1)
        pair_mask = node_mask[:, :, None] & src_mask[:, None, :] & ~self_pairs(pos, src_pos, dst_index)
        adj = ((dist < radial_cutoff) & pair_mask).to(pos.dtype)
        sh_dense, attr_dense = sh_fn(edge_vec), attr_fn(dist, bonded=False)

    src = torch.gather(src_pos, 1, bond_src[..., None].expand(-1, -1, 3))
    dst = torch.gather(pos, 1, bond_dst[..., None].expand(-1, -1, 3))
    bvec = src - dst
    bdist = torch.linalg.vector_norm(bvec + 1e-12, dim=-1)
    return EdgeData(
        sh_dense=sh_dense,
        attr_dense=attr_dense,
        adj=adj,
        sh_bond=sh_fn(bvec),
        attr_bond=attr_fn(bdist, bonded=True),
        bond_src=bond_src,
        bond_dst=bond_dst,
        bond_mask=bond_mask.to(pos.dtype),
        bond0_embed=bond0_embed,
        pos=pos,
        node_mask=node_mask,
        radial_cutoff=radial_cutoff,
        bond1_embed=bond1_embed,
    )
