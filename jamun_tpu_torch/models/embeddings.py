"""Atom embedder with residue information
(counterpart of `jamun_tpu/models/embeddings.py`)."""

from __future__ import annotations

import torch
from torch import nn

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.ops.irreps import Irreps

__all__ = ["Embed", "AtomEmbeddingWithResidueInformation"]


class Embed(nn.Module):
    """A lookup table with flax's parameter name `embedding` [num, dim]."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.data.copy_(torch.randn(self.embedding.shape, generator=generator))

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        return self.embedding[index]


class AtomEmbeddingWithResidueInformation(nn.Module):
    """Concatenated atom-type, atom-code, residue-code and residue-index
    embeddings; the sequence index is zeroed unless use_residue_sequence_index."""

    def __init__(
        self,
        atom_type_embedding_dim: int,
        atom_code_embedding_dim: int,
        residue_code_embedding_dim: int,
        residue_index_embedding_dim: int,
        use_residue_sequence_index: bool = False,
        num_atom_types: int = 20,
        max_sequence_length: int = 10,
        num_atom_codes: int = 10,
        num_residue_types: int = 25,
    ):
        super().__init__()
        self.use_residue_sequence_index = use_residue_sequence_index
        self.max_sequence_length = max_sequence_length
        self.Embed_0 = Embed(num_atom_types, atom_type_embedding_dim)
        self.Embed_1 = Embed(num_atom_codes, atom_code_embedding_dim)
        self.Embed_2 = Embed(num_residue_types, residue_code_embedding_dim)
        self.Embed_3 = Embed(max_sequence_length, residue_index_embedding_dim)
        dim = (
            atom_type_embedding_dim + atom_code_embedding_dim
            + residue_code_embedding_dim + residue_index_embedding_dim
        )
        self.irreps_out = Irreps(f"{dim}x0e")

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        seq = batch.residue_sequence_index
        if not self.use_residue_sequence_index:
            seq = torch.zeros_like(seq)
        return torch.cat(
            [
                self.Embed_0(batch.atom_type_index),
                self.Embed_1(batch.atom_code_index),
                self.Embed_2(batch.residue_code_index),
                self.Embed_3(torch.clamp(seq, 0, self.max_sequence_length - 1)),
            ],
            dim=-1,
        )
