"""Equivariant graph attention (SE(3)-Transformer style) on dense batches
(counterpart of `jamun_tpu/ops/attention.py`).

Queries per node, keys and values per edge (the per-edge products of the
fully connected `Conv`, no aggregation); the edge softmax is the
reference's: exponentials normalized by their *mean* over the incoming
edges of each destination, the attention weight sqrt(relu(alpha)). Dense
pairs are a masked [G, N, N] panel (`EdgeData.adj`); the bonded edge list
joins the same softmax through sums over its destinations. Plain PyTorch,
as JAX's runs XLA: no TPU kernel reaches it.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch
from torch import nn

from jamun_tpu_torch.ops.graph import EdgeData
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.layer_norm import equivariant_layer_norm
from jamun_tpu_torch.ops.linear import IrrepsLinear
from jamun_tpu_torch.ops.mlp import EquivariantMLP, ScalarMLP
from jamun_tpu_torch.ops.tensor_product import fully_connected_tp

__all__ = ["Attention", "MultiheadAttention", "TransformerBlock", "split_irreps"]


def split_irreps(irreps, n_head: int):
    """(the irreps of n_head heads side by side, one head's irreps)."""
    irreps = Irreps(irreps)
    for mi in irreps:
        if mi.mul % n_head:
            raise ValueError(f"{mi} not divisible by {n_head} heads")
    per_head = Irreps([(mi.mul // n_head, mi.ir) for mi in irreps])
    split = Irreps(list(itertools.chain.from_iterable([list(per_head)] * n_head)))
    assert split.dim == irreps.dim
    return split, per_head


def _sum_at(dst: torch.Tensor, values: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """values [G, B, C] summed into their destinations dst [G, B] -> [G, N, C]."""
    out = values.new_zeros((values.shape[0], num_nodes, values.shape[-1]))
    return out.scatter_add(1, dst[..., None].expand(-1, -1, values.shape[-1]), values)


class _PerEdgeConv(nn.Module):
    """The fully connected product of `Conv` per edge, without aggregation:
    its radial MLP's weights per uvw group (`ScalarMLP.split_forward`)."""

    def __init__(self, irreps_in, irreps_out, irreps_sh, edge_attr_dim: int):
        super().__init__()
        self.tp = fully_connected_tp(irreps_in, irreps_sh, irreps_out)
        self.radial_nn = ScalarMLP(edge_attr_dim, self.tp.weight_numel, [edge_attr_dim])

    def forward(self, src_attr, edge_attr, edge_sh):
        groups = self.tp.weight_groups(edge_attr.device)
        return self.tp(src_attr, edge_sh, self.radial_nn.split_forward(edge_attr, groups))


class MultiheadAttention(nn.Module):
    def __init__(
        self, irreps_in, irreps_out, irreps_sh, irreps_query, irreps_key, edge_attr_dim: int,
        n_head: int = 1,
    ):
        super().__init__()
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        self.n_head = n_head
        q_split, q_head = split_irreps(irreps_query, n_head)
        k_split, k_head = split_irreps(irreps_key, n_head)
        o_split, _ = split_irreps(self.irreps_out, n_head)
        self.IrrepsLinear_0 = IrrepsLinear(self.irreps_in, q_split)  # queries
        self._PerEdgeConv_0 = _PerEdgeConv(self.irreps_in, k_split, irreps_sh, edge_attr_dim)  # keys
        self._PerEdgeConv_1 = _PerEdgeConv(self.irreps_in, o_split, irreps_sh, edge_attr_dim)  # values
        self.dot = fully_connected_tp(q_head, k_head, Irreps("1x0e"))
        self.dot_w = nn.Parameter(torch.empty(self.dot.weight_numel))
        self.IrrepsLinear_1 = IrrepsLinear(o_split, self.irreps_out)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init of `dot_w`: N(0, 1)."""
        self.dot_w.data.copy_(torch.randn(self.dot_w.shape, generator=generator))

    def forward(self, node_attr: torch.Tensor, edges: EdgeData) -> torch.Tensor:
        """node_attr [G, N, irreps_in.dim] -> [G, N, irreps_out.dim]."""
        G, N, D = node_attr.shape
        B, H = edges.bond_src.shape[1], self.n_head
        h_k, h_v = self._PerEdgeConv_0, self._PerEdgeConv_1

        q = self.IrrepsLinear_0(node_attr).reshape(G, N, H, -1)  # per dst node
        src = node_attr[:, None].expand(G, N, N, D)
        k = h_k(src, edges.attr_dense, edges.sh_dense).reshape(G, N, N, H, -1)
        v = h_v(src, edges.attr_dense, edges.sh_dense).reshape(G, N, N, H, -1)
        src_b = torch.gather(node_attr, 1, edges.bond_src[..., None].expand(-1, -1, D))
        k_b = h_k(src_b, edges.attr_bond, edges.sh_bond).reshape(G, B, H, -1)
        v_b = h_v(src_b, edges.attr_bond, edges.sh_bond).reshape(G, B, H, -1)

        # logits: the invariant contraction of q[dst] with each edge's key
        logits = self.dot(q[:, :, None].expand(G, N, N, H, q.shape[-1]), k, self.dot_w)[..., 0]
        dst_b = edges.bond_dst
        q_bond = torch.gather(q.reshape(G, N, -1), 1, dst_b[..., None].expand(-1, -1, H * q.shape[-1]))
        logits_b = self.dot(q_bond.reshape(G, B, H, -1), k_b, self.dot_w)[..., 0]  # [G, B, H]

        # softmax over incoming edges, normalized by the MEAN of the exponentials
        adj, bond_mask = edges.adj, edges.bond_mask
        exp = torch.exp(logits) * adj[..., None]
        exp_b = torch.exp(logits_b) * bond_mask[..., None]
        z_sum = exp.sum(dim=2) + _sum_at(dst_b, exp_b, N)  # [G, N, H]
        deg = adj.sum(dim=-1) + _sum_at(dst_b, bond_mask[..., None], N)[..., 0]
        z = z_sum / torch.clamp(deg, min=1.0)[..., None]

        attn = torch.sqrt(torch.relu(exp / torch.clamp(z[:, :, None], min=1e-20)))
        out = torch.einsum("gijh,gijhd->gihd", attn, v).reshape(G, N, -1)
        z_bond = torch.gather(z, 1, dst_b[..., None].expand(-1, -1, H))  # [G, B, H]
        attn_b = torch.sqrt(torch.relu(exp_b / torch.clamp(z_bond, min=1e-20)))
        out = out + _sum_at(dst_b, (attn_b[..., None] * v_b).reshape(G, B, -1), N)
        return self.IrrepsLinear_1(out)


class Attention(MultiheadAttention):
    """Single-head attention."""

    def __init__(self, irreps_in, irreps_out, irreps_sh, irreps_query, irreps_key, edge_attr_dim: int):
        super().__init__(irreps_in, irreps_out, irreps_sh, irreps_query, irreps_key, edge_attr_dim, 1)


class TransformerBlock(nn.Module):
    """Attention, then a feed-forward EquivariantMLP (hidden 4 x each
    multiplicity), each inside a linear self-interaction and followed by the
    equivariant layer norm."""

    def __init__(
        self, irreps_in, irreps_out, irreps_sh, edge_attr_dim: int, n_head: int = 1,
        irreps_query: Optional[str] = None, irreps_key: Optional[str] = None,
    ):
        super().__init__()
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        irreps_q = Irreps(irreps_query) if irreps_query else self.irreps_in
        irreps_k = Irreps(irreps_key) if irreps_key else self.irreps_in
        self.MultiheadAttention_0 = MultiheadAttention(
            self.irreps_in, self.irreps_out, irreps_sh, irreps_q, irreps_k, edge_attr_dim, n_head
        )
        self.IrrepsLinear_0 = IrrepsLinear(self.irreps_in, self.irreps_out)  # skip around attention
        self.IrrepsLinear_1 = IrrepsLinear(self.irreps_out, self.irreps_out)
        ff_hidden = Irreps([(4 * mi.mul, mi.ir) for mi in self.irreps_out])
        self.EquivariantMLP_0 = EquivariantMLP(self.irreps_out, self.irreps_out, [ff_hidden])
        self.IrrepsLinear_2 = IrrepsLinear(self.irreps_out, self.irreps_out)  # skip around the MLP
        self.IrrepsLinear_3 = IrrepsLinear(self.irreps_out, self.irreps_out)

    def forward(self, node_attr: torch.Tensor, edges: EdgeData) -> torch.Tensor:
        skip = self.IrrepsLinear_0(node_attr)
        x = self.IrrepsLinear_1(self.MultiheadAttention_0(node_attr, edges)) + skip
        x = equivariant_layer_norm(x, self.irreps_out)
        y = self.IrrepsLinear_3(self.EquivariantMLP_0(x)) + self.IrrepsLinear_2(x)
        return equivariant_layer_norm(y, self.irreps_out)
