"""Ophiuchus: the hierarchical residue-level denoiser (counterpart of
`jamun_tpu/models/ophiuchus.py`).

Atoms pool to residues anchored at the alpha carbon, message passing runs on
a dense residue-level radius graph with no bonded edges, and the head
predicts the CA position plus each atom's offset from it. The residue layout
is the batch's [G, R, P] gather map (`GraphBatch.residue_atom_index` and its
fields, built by `data/batching.collate`), so the forward is gathers and one
scatter back to the atoms.

Every `ConvBlock` takes the plain path, with the uvw product of
`ops/tensor_product.py` (the arch files' default) or the separable one: JAX's
Ophiuchus reaches no Pallas kernel either (`use_pallas` is off there). The
submodules carry flax's automatic names (`Embed_0`, `IrrepsLinear_0`,
`SelfInteraction_k`, `ConvBlock_k`, ...), so `params.from_jax_params` maps a
JAX parameter tree onto this module one to one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from jamun_tpu_torch.models.e3conv import compute_dtype, irreps_to_vector, vector_to_irreps
from jamun_tpu_torch.models.embeddings import Embed
from jamun_tpu_torch.models.noise_conditioning import (
    NoiseConditionalScaling,
    NoiseConditionalSkipConnection,
)
from jamun_tpu_torch.ops.cg import real_wigner_3j
from jamun_tpu_torch.ops.conv import ConvBlock, takes_pair_list
from jamun_tpu_torch.ops.gate import Gate
from jamun_tpu_torch.ops.graph import EdgeData, GraphBatch, edge_pairs
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.linear import IrrepsLinear
from jamun_tpu_torch.ops.radial import soft_one_hot_linspace
from jamun_tpu_torch.ops.sh import spherical_harmonics
from jamun_tpu_torch.utils.device import resolve_device

__all__ = ["Ophiuchus", "SelfInteraction", "tensor_square"]

CA_CODE = 4  # the atom code of CA (`ResidueMetadata.ATOM_CODES.index("CA")`)
_COUPLINGS = {}  # (l1, l2, l3, dtype, device) -> the scaled coupling tensor


def _square_output_blocks(irreps_in: Irreps) -> Tuple[Irreps, List]:
    """Output blocks and instructions (i, j, mul_out, ir3) of the unweighted
    symmetric tensor square (e3nn's `o3.TensorSquare`): pairs i <= j, and
    for i == j only the symmetric couplings (l1 + l2 + l3 even)."""
    out_blocks, instructions = [], []
    for i, mi in enumerate(irreps_in):
        for j, mj in enumerate(irreps_in):
            if j < i:
                continue
            for ir3 in mi.ir * mj.ir:
                if i == j and (mi.ir.l + mj.ir.l + ir3.l) % 2 == 1:
                    continue  # the antisymmetric coupling vanishes in the square
                instructions.append((i, j, mi.mul * mj.mul, ir3))
                out_blocks.append((mi.mul * mj.mul, ir3))
    return Irreps(out_blocks), instructions


def _coupling(l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
    """real_wigner_3j(l1, l2, l3) * sqrt(2 l3 + 1) in `like`'s dtype, made
    once per device: a host tensor copied at every call would make the host
    wait for the work queued before it."""
    key = (l1, l2, l3, like.dtype, like.device)
    if key not in _COUPLINGS:
        c = real_wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
        _COUPLINGS[key] = torch.as_tensor(c, dtype=like.dtype, device=like.device)
    return _COUPLINGS[key]


def tensor_square(x: torch.Tensor, irreps_in) -> Tuple[torch.Tensor, Irreps]:
    """The unweighted symmetric tensor square of packed irreps features
    x [..., irreps_in.dim] -> ([..., irreps_out.dim], irreps_out)."""
    irreps_in = Irreps(irreps_in)
    irreps_out, instructions = _square_output_blocks(irreps_in)
    sl = irreps_in.slices()
    batch = x.shape[:-1]
    blocks = []
    for i, j, mul_out, ir3 in instructions:
        mi, mj = irreps_in[i], irreps_in[j]
        f1 = x[..., sl[i]].reshape(batch + (mi.mul, mi.ir.dim))
        f2 = x[..., sl[j]].reshape(batch + (mj.mul, mj.ir.dim))
        blk = torch.einsum("...ui,...vj,ijk->...uvk", f1, f2, _coupling(mi.ir.l, mj.ir.l, ir3.l, x))
        blocks.append(blk.reshape(batch + (mul_out * ir3.dim,)))
    return torch.cat(blocks, dim=-1), irreps_out


class SelfInteraction(nn.Module):
    """The tensor-square self interaction: the multiplicity factored onto an
    axis of `mul_factor`, squared, folded back, then a gated linear over the
    input and the square (the l = 2 blocks of the square have no output
    block and drop out) and a noise-conditional scaling."""

    def __init__(self, irreps_in, mul_factor: int):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.mul_factor = mul_factor
        if any(mi.mul % mul_factor for mi in self.irreps_in):
            raise ValueError(f"mul_factor {mul_factor} must divide every multiplicity of {self.irreps_in}")
        self.factored = Irreps([(mi.mul // mul_factor, mi.ir) for mi in self.irreps_in])
        self.irreps_sq = _square_output_blocks(self.factored)[0]
        squared = Irreps([(mul_factor * mi.mul, mi.ir) for mi in self.irreps_sq])
        self.gate = Gate(self.irreps_in)
        self.IrrepsLinear_0 = IrrepsLinear(self.irreps_in + squared, self.gate.irreps_in)
        self.NoiseConditionalScaling_0 = NoiseConditionalScaling(self.gate.irreps_out)

    def forward(self, features: torch.Tensor, c_noise: torch.Tensor) -> torch.Tensor:
        batch, F = features.shape[:-1], self.mul_factor
        parts = [  # [..., mul * d] -> [..., F, mul / F * d]
            features[..., s].reshape(batch + (F, fi.mul * mi.ir.dim))
            for s, mi, fi in zip(self.irreps_in.slices(), self.irreps_in, self.factored)
        ]
        squared, irreps_sq = tensor_square(torch.cat(parts, dim=-1), self.factored)
        merged = [  # the factor axis back into the multiplicities
            squared[..., s].reshape(batch + (F * mi.mul * mi.ir.dim,))
            for s, mi in zip(irreps_sq.slices(), irreps_sq)
        ]
        x = self.IrrepsLinear_0(torch.cat([features, *merged], dim=-1))
        return self.NoiseConditionalScaling_0(self.gate(x), c_noise)


class Ophiuchus(nn.Module):
    def __init__(
        self,
        irreps_out: str = "1x1e",
        irreps_hidden: str = "64x0e + 64x1e",
        irreps_sh: str = "1x0e + 1x1e",
        n_layers: int = 4,
        mul_factor: int = 64,
        edge_attr_dim: int = 8,
        atom_type_embedding_dim: int = 8,
        atom_code_embedding_dim: int = 8,
        residue_code_embedding_dim: int = 32,
        residue_index_embedding_dim: int = 8,
        use_residue_sequence_index: bool = False,
        tensor_product: str = "uvw",
        dtype: Union[torch.dtype, str, None] = None,
        max_atoms_in_residue: int = 16,
        max_sequence_length: int = 20,
        device=None,
        seed: Optional[int] = None,
    ):
        """The arch files' keys are JAX's; `max_atoms_in_residue` is P of the
        residue layout (`BucketSpec.max_atoms_per_residue`), which sizes the
        embedding and the head, so a batch of another P raises. `device`
        follows `utils.device.resolve_device` (the card unless "cpu");
        `seed` draws the parameters (flax's init distributions) from a CPU
        generator."""
        super().__init__()
        self.irreps_out, self.irreps_hidden = Irreps(irreps_out), Irreps(irreps_hidden)
        self.irreps_sh = Irreps(irreps_sh)
        self.n_layers = n_layers
        self.edge_attr_dim = edge_attr_dim
        self.use_residue_sequence_index = use_residue_sequence_index
        self.max_sequence_length = max_sequence_length
        self.tensor_product = tensor_product
        self.dtype = compute_dtype(dtype)
        P = self.P = max_atoms_in_residue
        self.Embed_0 = Embed(7, atom_code_embedding_dim)
        self.Embed_1 = Embed(6, atom_type_embedding_dim)
        self.Embed_2 = Embed(23, residue_code_embedding_dim)
        irreps_embed = Irreps(
            f"{P}x1e + {P * atom_code_embedding_dim}x0e + {P * atom_type_embedding_dim}x0e + "
            f"{residue_code_embedding_dim}x0e"
        )
        if use_residue_sequence_index:
            self.Embed_3 = Embed(max_sequence_length, residue_index_embedding_dim)
            irreps_embed = irreps_embed + Irreps(f"{residue_index_embedding_dim}x0e")
        self.IrrepsLinear_0 = IrrepsLinear(irreps_embed, self.irreps_hidden)
        for k in range(n_layers):
            self.add_module(f"SelfInteraction_{k}", SelfInteraction(self.irreps_hidden, mul_factor))
            self.add_module(f"ConvBlock_{k}", ConvBlock(
                self.irreps_hidden, self.irreps_hidden, self.irreps_sh, edge_attr_dim, self.dtype,
                tensor_product=tensor_product,
            ))
            self.add_module(f"NoiseConditionalScaling_{k}", NoiseConditionalScaling(self.irreps_hidden))
            self.add_module(
                f"NoiseConditionalSkipConnection_{k}", NoiseConditionalSkipConnection(self.irreps_hidden)
            )
        self.IrrepsLinear_1 = IrrepsLinear(self.irreps_hidden, self.irreps_out)  # the CA position
        self.IrrepsLinear_2 = IrrepsLinear(  # each atom's offset from it
            self.irreps_hidden, Irreps([(P * mi.mul, mi.ir) for mi in self.irreps_out])
        )
        self.pair_lists = takes_pair_list(self)
        if seed is not None:
            self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: N(0, 1) embeddings and IrrepsLinear kernels,
        U(+-1/sqrt(fan_in)) radial Dense layers, identity noise scaling."""
        with torch.no_grad():
            for m in self.modules():
                if m is not self and hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)

    def _residue_edges(self, base: torch.Tensor, residue_mask: torch.Tensor, radial_cutoff,
                       dtype: torch.dtype) -> EdgeData:
        """The dense residue radius graph between CA positions [G, R, 3], no
        self pairs and no bonded edges."""
        G, R = residue_mask.shape
        edge_vec = base[:, None, :, :] - base[:, :, None, :]  # [g, i(dst), j(src)]
        dist = torch.linalg.vector_norm(edge_vec + 1e-12, dim=-1)
        eye = torch.eye(R, dtype=torch.bool, device=base.device)[None]
        adj = (dist < radial_cutoff) & residue_mask[:, :, None] & residue_mask[:, None, :] & ~eye
        empty = torch.zeros((G, 0), dtype=torch.int64, device=base.device)
        return EdgeData(
            sh_dense=spherical_harmonics(self.irreps_sh, edge_vec),
            attr_dense=soft_one_hot_linspace(dist, 0.0, radial_cutoff, self.edge_attr_dim),
            adj=adj.to(dtype),
            sh_bond=base.new_zeros((G, 0, self.irreps_sh.dim)),
            attr_bond=base.new_zeros((G, 0, self.edge_attr_dim)),
            bond_src=empty,
            bond_dst=empty,
            bond_mask=base.new_zeros((G, 0)),
        )

    def forward(self, batch: GraphBatch, c_noise: torch.Tensor, radial_cutoff) -> torch.Tensor:
        """batch.pos are the scaled noisy positions; c_noise [1]. Returns the
        per-atom output irreps [G, N, 3] (the l=1 order y, z, x)."""
        if batch.residue_atom_index is None:
            raise ValueError("Ophiuchus reads the residue layout: collate with "
                             "BucketSpec(with_residue_layout=True)")
        G, R, P = batch.residue_atom_index.shape
        if P != self.P:
            raise ValueError(f"residue layout of {P} atoms per residue; this arch has {self.P}")
        pos = batch.pos
        flat_idx = batch.residue_atom_index.reshape(G, R * P)
        atom_mask = batch.residue_atom_mask
        maskf = atom_mask.to(pos.dtype)[..., None]  # [G, R, P, 1]

        # pool the atoms to residues anchored at CA
        base = torch.gather(pos, 1, batch.residue_ca_index[..., None].expand(-1, -1, 3))
        atom_pos = torch.gather(pos, 1, flat_idx[..., None].expand(-1, -1, 3)).reshape(G, R, P, 3)
        rel = (atom_pos - base[:, :, None, :]) * maskf
        atom_codes = torch.gather(batch.atom_code_index, 1, flat_idx).reshape(G, R, P) * atom_mask
        atom_types = torch.gather(batch.atom_type_index, 1, flat_idx).reshape(G, R, P) * atom_mask

        # the residue embedding
        feats = [
            vector_to_irreps(rel).reshape(G, R, P * 3),
            (self.Embed_0(atom_codes) * maskf).reshape(G, R, -1),
            (self.Embed_1(atom_types) * maskf).reshape(G, R, -1),
            self.Embed_2(batch.residue_codes),
        ]
        if self.use_residue_sequence_index:
            seq = torch.arange(R, device=pos.device).clamp(max=self.max_sequence_length - 1)
            feats.append(self.Embed_3(seq)[None].expand(G, -1, -1))
        features = self.IrrepsLinear_0(torch.cat(feats, dim=-1))

        edges = self._residue_edges(base, batch.residue_mask, radial_cutoff, features.dtype)
        if self.pair_lists:  # one list of live residue pairs for every layer
            edges = dataclasses.replace(edges, pairs=edge_pairs(edges))
        for k in range(self.n_layers):
            new = getattr(self, f"SelfInteraction_{k}")(features, c_noise)
            new = getattr(self, f"ConvBlock_{k}")(new, edges)
            new = getattr(self, f"NoiseConditionalScaling_{k}")(new, c_noise)
            features = getattr(self, f"NoiseConditionalSkipConnection_{k}")(features, new, c_noise)

        # the head: the CA position plus each atom's offset (zero for CA)
        base_xyz = irreps_to_vector(self.IrrepsLinear_1(features))  # [G, R, 3]
        rel_xyz = irreps_to_vector(self.IrrepsLinear_2(features).reshape(G, R, P, 3))
        rel_xyz = torch.where((atom_codes == CA_CODE)[..., None], 0.0, rel_xyz)
        atom_out = ((base_xyz[:, :, None, :] + rel_xyz) * maskf).reshape(G, R * P, 3)
        # each real atom appears once; padded slots add exact zeros to atom 0
        out = pos.new_zeros((G, pos.shape[1], 3)).scatter_add(
            1, flat_idx[..., None].expand(-1, -1, 3), atom_out.to(pos.dtype)
        )
        return vector_to_irreps(out) * batch.node_mask[..., None].to(out.dtype)
