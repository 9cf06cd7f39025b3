"""Host-side collation: GraphTemplate + frames -> a padded `GraphBatch`
(counterpart of `jamun_tpu/data/batching.py`).

Graphs are padded to bucket sizes (N, B), so every batch shape comes from a
small fixed set. `pad_to_bucket` is the JAX package's; `collate` stacks its
rows into the port's `GraphBatch` (int64 indices, bool masks), with the
residue layout that Ophiuchus reads when `BucketSpec.with_residue_layout`
(the default), as JAX's does. Where a CUDA card is present the batch is
made in page-locked host memory, so that `GraphBatch.to_device` copies it
without a wait.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from jamun_tpu_torch.data.topology import GraphTemplate
from jamun_tpu_torch.ops.graph import GraphBatch

__all__ = ["BucketSpec", "pad_to_bucket", "collate", "template_to_batch"]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static padding buckets. Nodes/bonds are rounded up to the next bucket."""

    node_buckets: Tuple[int, ...] = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)
    bond_multiplier: float = 2.2  # directed bonds ~ 2 * (n - 1) plus rings
    max_atoms_per_residue: int = 16  # residue layout pad (Ophiuchus parity)
    residue_bucket_multiple: int = 4
    with_residue_layout: bool = True

    def node_bucket(self, n: int) -> int:
        for b in self.node_buckets:
            if n <= b:
                return b
        return int(2 ** math.ceil(math.log2(n)))

    def bond_bucket(self, n_nodes_bucket: int) -> int:
        return int(self.bond_multiplier * n_nodes_bucket)

    def residue_bucket(self, r: int) -> int:
        m = self.residue_bucket_multiple
        return max(((r + m - 1) // m) * m, m)


def pad_to_bucket(
    template: GraphTemplate,
    pos: np.ndarray,
    n_pad: int,
    b_pad: int,
    r_pad: Optional[int] = None,
    p_pad: int = 16,
) -> dict:
    """One graph -> padded per-graph arrays (no leading G axis)."""
    n = template.num_atoms
    nb = len(template.bond_src)
    assert n <= n_pad, (n, n_pad)
    assert nb <= b_pad, (nb, b_pad)

    def pad_n(x, fill=0):
        out = np.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    pos_p = np.zeros((n_pad, 3), dtype=np.float32)
    pos_p[:n] = pos
    node_mask = np.zeros((n_pad,), bool)
    node_mask[:n] = True
    bond_src = np.zeros((b_pad,), np.int32)
    bond_dst = np.zeros((b_pad,), np.int32)
    bond_mask = np.zeros((b_pad,), bool)
    bond_src[:nb] = template.bond_src
    bond_dst[:nb] = template.bond_dst
    bond_mask[:nb] = True

    residue = {}
    if r_pad is not None:
        P = p_pad
        res_atom_idx = np.zeros((r_pad, P), np.int32)
        res_atom_mask = np.zeros((r_pad, P), bool)
        ca_index = np.zeros((r_pad,), np.int32)
        res_mask = np.zeros((r_pad,), bool)
        res_codes = np.zeros((r_pad,), np.int32)
        counts = np.zeros((r_pad,), np.int32)
        CA_CODE = 4  # ResidueMetadata.ATOM_CODES.index("CA")
        for a in range(n):
            r = int(template.residue_sequence_index[a])
            if r >= r_pad or counts[r] >= P:
                continue
            res_atom_idx[r, counts[r]] = a
            res_atom_mask[r, counts[r]] = True
            counts[r] += 1
            res_mask[r] = True
            res_codes[r] = template.residue_code_index[a]
            if template.atom_code_index[a] == CA_CODE:
                ca_index[r] = a
        residue = dict(
            residue_atom_index=res_atom_idx,
            residue_atom_mask=res_atom_mask,
            residue_ca_index=ca_index,
            residue_mask=res_mask,
            residue_codes=res_codes,
        )

    return dict(
        **residue,
        pos=pos_p,
        node_mask=node_mask,
        atom_type_index=pad_n(template.atom_type_index),
        atom_code_index=pad_n(template.atom_code_index),
        residue_code_index=pad_n(template.residue_code_index),
        residue_sequence_index=pad_n(template.residue_sequence_index),
        bond_src=bond_src,
        bond_dst=bond_dst,
        bond_mask=bond_mask,
        loss_weight=np.float32(template.loss_weight),
        graph_mask=True,
    )


def collate(
    items: Sequence[Tuple[GraphTemplate, np.ndarray]],
    bucket_spec: Optional[BucketSpec] = None,
    num_graphs: Optional[int] = None,
) -> GraphBatch:
    """Collate (template, frame_pos) pairs into one padded GraphBatch.

    All graphs are padded to the max bucket in the batch; if `num_graphs` is
    given, the batch is padded with masked dummy graphs up to that count.
    """
    bucket_spec = bucket_spec or BucketSpec()
    n_pad = max(bucket_spec.node_bucket(t.num_atoms) for t, _ in items)
    b_pad = max(
        max((len(t.bond_src) for t, _ in items), default=1),
        bucket_spec.bond_bucket(n_pad),
    )
    r_pad = None
    if bucket_spec.with_residue_layout:
        r_pad = bucket_spec.residue_bucket(max(t.num_residues for t, _ in items))
    rows = [
        pad_to_bucket(t, p, n_pad, b_pad, r_pad, bucket_spec.max_atoms_per_residue)
        for t, p in items
    ]
    G = num_graphs or len(rows)
    while len(rows) < G:
        dummy = {k: np.zeros_like(v) if isinstance(v, np.ndarray) else type(v)(0) for k, v in rows[0].items()}
        dummy["graph_mask"] = False
        rows.append(dummy)

    pin = torch.cuda.is_available()

    def stack(key):
        t = torch.from_numpy(np.stack([np.asarray(r[key]) for r in rows]))
        if t.dtype == torch.int32:
            t = t.to(torch.int64)
        return t.pin_memory() if pin else t

    return GraphBatch(**{f.name: stack(f.name) for f in dataclasses.fields(GraphBatch)
                         if f.name in rows[0]})


def template_to_batch(
    template: GraphTemplate,
    pos: np.ndarray,
    num_copies: int = 1,
    bucket_spec: Optional[BucketSpec] = None,
) -> GraphBatch:
    """Replicate one molecule `num_copies` times (e.g. parallel sampling chains)."""
    pos = np.asarray(pos)
    if pos.ndim == 2:
        items = [(template, pos)] * num_copies
    else:
        items = [(template, pos[i % len(pos)]) for i in range(num_copies)]
    return collate(items, bucket_spec)
