"""E3Conv: the E(3)-equivariant message-passing denoiser network.

Counterpart of `jamun_tpu/models/e3conv.py` for any `irreps_hidden`,
`irreps_sh` and `tensor_product` JAX's takes. Parameters carry the flax
names (`ConvBlock_0`, `_HiddenLayer_k`, `EquivariantMLP_0`, ...), so
`params.from_jax_params` maps a JAX param tree onto this module one to one.

`tensor_product` is JAX's, "uvw" by default: e3nn's fully connected product
(`ops/tensor_product.py`) and the experimental product
(`ops/experimental_tp.py`) run JAX's generic dense or sparse path on either
device, as every kernel route in JAX is gated on "uvu". Whether a model may
take the kernels is decided once, at construction, from its structure, by
JAX's gates (`jamun_tpu/models/e3conv.py:501-575`, `jamun_tpu/ops/conv.py:
77-92, 175-183`): the uvu product, hidden irreps `Sx0e + Vx1e` (V > 0), SH
`1x0e + 1x1e` and outputs of l <= 1 and even parity (`kernels`). A model
outside those (SH or hidden irreps with l = 2, say) runs the plain path on
either device, as JAX's runs XLA. `plain=True`, or `use_pallas=False` as
the arch files spell it, is the CPU reference path: a call on the card
raises.

The ways through the forward of a model whose structure takes the kernels,
picked once per call as JAX's `E3Conv` picks them
(`jamun_tpu/models/e3conv.py:332-404`):
  - `fused_stack=True`, for calls that nothing differentiates (the walk):
    the whole forward after the atom embedding in one launch
    (`ops/cuda/e3_stack`, K3) at N <= 64 and one noise level. Under
    autograd, at N > 64 or outside K3's shapes the call takes the layerwise
    kernel path below (`_stack_ok`).
  - the layerwise kernel path (the default), every ConvBlock (the projector
    and each hidden layer) as one fused block. On the card these are the
    hand-written CUDA kernels, on the CPU their plain twins. Up to 128
    atoms: edge features once per forward (`ops/cuda/edge_features`, K1),
    then `ops/cuda/conv_block` (K2), under autograd with K4
    (`ops/cuda/conv_block_bwd`) as each block's backward. Above 128 atoms:
    `ops/cuda/fused_block_tiled` (K5), which rebuilds the pair geometry from
    the positions, so K1 is not launched and no [G, N, N, *] tensor exists.
    The EquivariantMLP head then runs in the compute dtype, as JAX's chained
    kernel path runs it (`_transposed_head`).
  - the plain path (library ops on `ops/graph.dense_edge_data`): a call that
    wants a gradient above 128 atoms takes it wholesale, on either device,
    as JAX's training dispatch sends such calls to XLA; position gradients
    work there. With `tiled_kernel_training=True` (JAX's benchmarking
    escape hatch, off by default) such a call takes K5 instead, whose
    backward recomputes the block with K5's plain twin under autograd
    (`fused_block_tiled_trainable`). `plain=True` forces the plain path (CPU
    only): the reference the kernel path is held to. A call "wants a gradient" when autograd is on and the
    positions or any parameter require one, so inference above 128 atoms
    must run under `torch.no_grad()` (or with `requires_grad_(False)`):
    otherwise it leaves K5 for this path and its [G, N, N, 704] messages per
    layer. The samplers of `sampling/walkjump.py` turn autograd off
    themselves.
  - the sparse capped-neighbour path (`jamun_tpu/models/e3conv.py:203-305`),
    for `neighbor_mode="nbr"`, and for `"auto"` (the default) from JAX's
    thresholds on (512 atoms, 256 for a call that wants a gradient): the
    K = `neighbor_cap` nearest sources inside the cutoff per atom
    (`ops/neighbors.py`), or the caller's Verlet-cached list (`nbr_cache`,
    from `sampling/mcmc.NeighborCachedScore`) with the true-cutoff mask
    recomputed. Every ConvBlock runs the standard block, and the head is the
    plain `EquivariantMLP_0` (JAX's `chained` is off there). A call without
    a gradient takes its messages from K6 (`ops/cuda/nbr_conv`) six times
    per forward; with `nbr_geom_kernel=True` and a cache, the edge features
    come from K7 (`ops/cuda/nbr_edge_features`) once per forward (JAX's
    `JAMUN_NBR_GEOM_KERNEL=1`). A call that wants a gradient runs the plain
    sparse path (`fast_uvu_messages_nbr` under autograd) on either device,
    as JAX sends `training=True` to XLA. `with_telemetry=True` also returns
    {"neighbor_overflow": [G]}, the in-cutoff edges the cap dropped (not
    counted on a cached list), in place of flax's `sow`.
`"dense"` runs the dense paths at any size. A model whose structure takes
the kernels but whose sizes (edge_attr_dim, radial width, N) are outside
them raises NotImplementedError on the card. Under `atom_axis` (the
atom-sharded mode, `parallel/atom_sharded.py`) every call takes the plain
path on either device, dense or sparse as "auto" decides on the whole
molecule, with the sources gathered from every rank (JAX gates each kernel
off there: `jamun_tpu/models/e3conv.py:220,356,512,548`).

`pallas_variant` is JAX's (`jamun_tpu/models/e3conv.py:120`). `"packed"`, the
default, is every path above. `"plane"` takes the dense calls (any N the
dense path takes) the way JAX's does: no whole-model kernel whatever
`fused_stack` says, no K1 precompute and no fused blocks
(`jamun_tpu/models/e3conv.py:350-354, 508-511, 544-547`,
`jamun_tpu/ops/conv.py:497`); `dense_edge_data` once per forward, every
ConvBlock the standard block, and the plain `EquivariantMLP_0` head. In a
call without a gradient each hidden layer's `Conv` runs K9
(`ops/cuda/dense_conv.fused_uvu_conv_dense`), five launches per forward; the
projector (V = 0, which K9 does not take) runs the plain dense path, as
JAX's runs XLA there. A call that wants a gradient takes the plain path.
The sparse path does not read the variant (K6, as in JAX). The parameter
tree is the same for both variants, so `params.from_jax_params` maps either.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from jamun_tpu_torch.models.embeddings import AtomEmbeddingWithResidueInformation, SimpleAtomEmbedding
from jamun_tpu_torch.models.noise_conditioning import (
    NoiseConditionalScaling,
    NoiseConditionalSkipConnection,
)
from jamun_tpu_torch.ops.conv import PALLAS_VARIANTS, ConvBlock
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import e3_stack as k3
from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5
from jamun_tpu_torch.ops.cuda.conv_block import EDGE_FEATURE_ATOMS
from jamun_tpu_torch.ops.cuda.edge_features import edge_features
from jamun_tpu_torch.ops.cuda.nbr_edge_features import nbr_edge_features
from jamun_tpu_torch.ops.graph import GraphBatch, dense_edge_data
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.mlp import EquivariantMLP, xla_sigmoid
from jamun_tpu_torch.ops.neighbors import neighbor_edge_data
from jamun_tpu_torch.ops.radial import soft_one_hot_linspace
from jamun_tpu_torch.ops.sh import SH_IRREPS, spherical_harmonics
from jamun_tpu_torch.parallel.mesh import all_gather, check_axis_name, gather_halo, resolve_group
from jamun_tpu_torch.utils.device import resolve_device

__all__ = [
    "E3Conv", "irreps_to_vector", "vector_to_irreps", "neighbor_mode_auto", "compute_dtype",
    "kernel_structure", "EDGE_FEATURE_ATOMS",
]

# "auto" neighbour mode: from these atom counts on JAX takes the sparse
# capped-neighbour path (`jamun_tpu/models/e3conv.py:38-44`)
_NBR_AUTO_TRAIN_N = 256
_NBR_AUTO_SAMPLE_N = 512
_DTYPES = {None: None, "bfloat16": torch.bfloat16}  # the arch files' dtype strings


def neighbor_mode_auto(n_atoms: int, training: bool) -> bool:
    """True when "auto" neighbour mode resolves to the sparse path."""
    return n_atoms >= (_NBR_AUTO_TRAIN_N if training else _NBR_AUTO_SAMPLE_N)


def compute_dtype(dtype: Union[torch.dtype, str, None]) -> Optional[torch.dtype]:
    """An arch's compute dtype: a torch dtype, or the arch files' "bfloat16"
    / null."""
    if isinstance(dtype, str) or dtype is None:
        if dtype not in _DTYPES:
            raise ValueError(f"dtype={dtype!r}")
        return _DTYPES[dtype]
    return dtype


def kernel_structure(tensor_product: str, irreps_hidden, irreps_sh, irreps_out) -> bool:
    """JAX's structural gates of the kernel paths (`_chained_ok`,
    `_stack_ok`, `Conv._fast_uvu_supported`): the uvu product, hidden
    irreps `Sx0e + Vx1e` with V > 0, SH `1x0e + 1x1e`, and outputs of l <= 1
    and even parity. Sizes (N, widths) are checked per call."""
    sv = Irreps(irreps_hidden).sv_shape()
    return (
        tensor_product == "uvu" and sv is not None and sv[1] > 0 and Irreps(irreps_sh) == SH_IRREPS
        and all(mi.ir.l <= 1 and mi.ir.p == 1 for mi in Irreps(irreps_out))
    )


def vector_to_irreps(v: torch.Tensor) -> torch.Tensor:
    """(x, y, z) -> the l=1 component order (y, z, x), from slices."""
    return torch.cat([v[..., 1:3], v[..., 0:1]], dim=-1)


def irreps_to_vector(f: torch.Tensor) -> torch.Tensor:
    """The l=1 component order (y, z, x) -> (x, y, z). Built from slices: an
    index list would become an index tensor copied from the host at every
    call, and on the card that copy waits for the whole forward queued
    before it, so the host could never run ahead of the device."""
    return torch.cat([f[..., 2:3], f[..., 0:2]], dim=-1)


class _HiddenLayer(nn.Module):
    """Noise scaling -> ConvBlock -> noise-conditional skip blend."""

    def __init__(
        self, irreps_hidden, irreps_sh, edge_attr_dim, dtype, pallas_variant="packed",
        tensor_product="uvu",
    ):
        super().__init__()
        self.NoiseConditionalScaling_0 = NoiseConditionalScaling(irreps_hidden)
        self.ConvBlock_0 = ConvBlock(
            irreps_hidden, irreps_hidden, irreps_sh, edge_attr_dim, dtype, pallas_variant,
            tensor_product,
        )
        self.NoiseConditionalSkipConnection_0 = NoiseConditionalSkipConnection(irreps_hidden)

    def forward(self, x, c_noise, block):
        out = block(self.ConvBlock_0, self.NoiseConditionalScaling_0(x, c_noise))
        return self.NoiseConditionalSkipConnection_0(x, out, c_noise)


class E3Conv(nn.Module):
    def __init__(
        self,
        irreps_out: str = "1x1e",
        irreps_hidden: str = "120x0e + 32x1e",
        irreps_sh: str = "1x0e + 1x1e",
        n_layers: int = 5,
        edge_attr_dim: int = 64,
        atom_type_embedding_dim: int = 8,
        atom_code_embedding_dim: int = 8,
        residue_code_embedding_dim: int = 32,
        residue_index_embedding_dim: int = 8,
        use_residue_information: bool = True,
        use_residue_sequence_index: bool = False,
        tensor_product: str = "uvw",
        dtype: Union[torch.dtype, str, None] = None,
        use_pallas: bool = True,
        neighbor_mode: str = "auto",
        neighbor_cap: int = 32,
        nbr_geom_kernel: bool = False,
        plain: bool = False,
        fused_stack: bool = False,
        pallas_variant: str = "packed",
        device=None,
        seed: Optional[int] = None,
        atom_axis: Optional[str] = None,
        scan_layers: bool = False,
        tiled_kernel_training: bool = False,
    ):
        """`dtype` is the compute dtype (parameters stay f32), a torch dtype
        or the arch files' "bfloat16" / null; `use_pallas=False` is the arch
        files' spelling of `plain=True` (the CPU reference path); `fused_stack`
        turns the whole-model kernel on for calls without a gradient (the
        parameters are the same tree either way); `neighbor_cap` is K of the
        sparse path, `nbr_geom_kernel` its K7 switch (cached lists, calls
        without a gradient; off by default, as in JAX); `device`
        follows `utils.device.resolve_device` (the card unless "cpu");
        `seed` draws the parameters (flax's init distributions) from a CPU
        generator, so a seed gives the same weights on any device;
        `pallas_variant` ("packed" | "plane") is JAX's (module docstring);
        `use_residue_information=False` embeds atoms by type alone, in the
        four embedding widths summed (JAX's `SimpleAtomEmbedding`).

        JAX's last three fields: `atom_axis` is the atom-sharded mode's
        process group (or "data", the default group; `parallel/
        atom_sharded.py` calls `sharded_forward` with its group): the batch holds this
        rank's destination rows, positions are gathered once per forward and
        features once per layer, and every call runs the plain path, as
        JAX's; `scan_layers` is JAX's `nn.scan` over the hidden layers,
        whose parameters flax stacks on a leading axis under
        `Scan_HiddenLayer_0`: the port keeps its `_HiddenLayer_k` modules
        and their per-layer compute, `params.from_jax_params` /
        `to_jax_params(..., scan_layers=True)` slice and stack that subtree,
        and the whole-model kernel stays off, as JAX's `_stack_ok` keeps it
        off under scan; `tiled_kernel_training` lets a call that wants a
        gradient above 128 atoms take K5 forward (`ops/cuda/
        fused_block_tiled.fused_block_tiled_trainable`) instead of the plain
        path."""
        super().__init__()
        check_axis_name(atom_axis)
        self.atom_axis = atom_axis
        self.scan_layers = scan_layers
        self.tiled_kernel_training = tiled_kernel_training
        dtype = compute_dtype(dtype)
        if neighbor_mode not in ("dense", "nbr", "auto"):
            raise ValueError(f"neighbor_mode={neighbor_mode!r}")
        if pallas_variant not in PALLAS_VARIANTS:
            raise ValueError(f"pallas_variant={pallas_variant!r}")
        self.pallas_variant = pallas_variant
        self.irreps_hidden, self.irreps_out = Irreps(irreps_hidden), Irreps(irreps_out)
        self.irreps_sh = Irreps(irreps_sh)
        self.n_layers = n_layers
        self.edge_attr_dim = edge_attr_dim
        self.dtype = dtype
        self.neighbor_mode = neighbor_mode
        self.neighbor_cap = neighbor_cap
        self.nbr_geom_kernel = nbr_geom_kernel
        self.plain = plain or not use_pallas
        self.tensor_product = tensor_product
        # calls may take the kernels: JAX's structural gates, once
        self.kernels = not self.plain and kernel_structure(
            tensor_product, self.irreps_hidden, self.irreps_sh, self.irreps_out
        )
        self.fused_stack = fused_stack
        self.bonded_dim = edge_attr_dim // 2
        self.radial_dim = (edge_attr_dim + 1) // 2

        self.embed_bondedness = nn.Parameter(torch.empty(2, self.bonded_dim))
        # under flax's name of the embedder JAX builds for this setting
        if use_residue_information:
            self.AtomEmbeddingWithResidueInformation_0 = AtomEmbeddingWithResidueInformation(
                atom_type_embedding_dim, atom_code_embedding_dim,
                residue_code_embedding_dim, residue_index_embedding_dim,
                use_residue_sequence_index,
            )
        else:
            self.SimpleAtomEmbedding_0 = SimpleAtomEmbedding(
                atom_type_embedding_dim + atom_code_embedding_dim
                + residue_code_embedding_dim + residue_index_embedding_dim
            )
        irreps_node = self.embedder.irreps_out
        self.NoiseConditionalScaling_0 = NoiseConditionalScaling(irreps_node)
        self.ConvBlock_0 = ConvBlock(
            irreps_node, self.irreps_hidden, self.irreps_sh, edge_attr_dim, dtype, pallas_variant,
            tensor_product,
        )
        for k in range(n_layers):
            self.add_module(
                f"_HiddenLayer_{k}",
                _HiddenLayer(
                    self.irreps_hidden, self.irreps_sh, edge_attr_dim, dtype, pallas_variant,
                    tensor_product,
                ),
            )
        self.EquivariantMLP_0 = EquivariantMLP(
            self.irreps_hidden, self.irreps_out, [self.irreps_hidden]
        )
        self.output_gain = nn.Parameter(torch.zeros(()))
        if seed is not None:
            self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: N(0, 1) embeddings and IrrepsLinear kernels,
        U(+-1/sqrt(fan_in)) radial Dense layers, identity noise scaling,
        output_gain 0."""
        with torch.no_grad():
            self.embed_bondedness.copy_(torch.randn(self.embed_bondedness.shape, generator=generator))
            self.output_gain.zero_()
            for m in self.modules():
                if m is not self and hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)

    @property
    def embedder(self) -> nn.Module:
        """The atom embedder: with residue information, or by atom type alone."""
        if hasattr(self, "SimpleAtomEmbedding_0"):
            return self.SimpleAtomEmbedding_0
        return self.AtomEmbeddingWithResidueInformation_0

    def _hidden_layers(self):
        return [getattr(self, f"_HiddenLayer_{k}") for k in range(self.n_layers)]

    def kernel_path_supported(self, n_atoms: int) -> bool:
        """The sizes the layerwise kernels cover (K1 and K2 up to 128 atoms,
        K5 above) for a model whose structure takes them (`kernels`): the
        widths; the atom count only through K5's pair index."""
        S, V = self.irreps_hidden.sv_shape()
        S_emb = self.embedder.irreps_out.sv_shape()[0]
        return (
            n_atoms <= k5.MAX_ATOMS
            and self.edge_attr_dim == 2 * k2.N_RADIAL
            and max(2 * S + 3 * V, 2 * S_emb) <= k2.MAX_WIDTH
        )

    def _wants_grad(self, batch: GraphBatch) -> bool:
        """Whether autograd will differentiate this call (the counterpart of
        JAX's `training=True`)."""
        return torch.is_grad_enabled() and (
            batch.pos.requires_grad or any(p.requires_grad for p in self.parameters())
        )

    def _stack_ok(self, batch: GraphBatch, c_noise: torch.Tensor) -> bool:
        """Whether this call runs the whole-model kernel: the flag is on and
        `scan_layers` off (JAX's `_stack_ok`), nothing wants a gradient (the
        kernel is forward only; the counterpart of JAX's `training=False`),
        one noise level, and a shape K3 takes (`stack_supported`: N <= 64)."""
        if (
            not self.fused_stack or self.scan_layers or not self.kernels
            or self.pallas_variant != "packed" or c_noise.numel() != 1
        ):
            return False
        if self._wants_grad(batch):
            return False
        S, V = self.irreps_hidden.sv_shape()
        S_emb = self.embedder.irreps_out.sv_shape()[0]
        out_blocks = tuple((mi.mul, mi.ir.l, mi.ir.p) for mi in self.irreps_out)
        return self.edge_attr_dim == 2 * k2.N_RADIAL and k3.stack_supported(
            batch.pos.shape[1], S, V, S_emb, out_blocks
        )

    def _stack_weights(self, cdt):
        """K3's operands from the modules' parameters: the projector's and
        the stacked hidden blocks' `BlockWeights` and the head's weights."""
        S, V = self.irreps_hidden.sv_shape()
        bond0, bond1 = self.embed_bondedness[0], self.embed_bondedness[1]

        def masters(blk):
            conv = blk.Conv_0
            return k2.block_master_weights(
                conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
                bond0, bond1, S=conv.S, V=conv.V,
            )

        hidden = [masters(layer.ConvBlock_0) for layer in self._hidden_layers()]
        return (
            k2.cast_block_weights(masters(self.ConvBlock_0), cdt),
            k2.cast_block_weights(k3.stack_block_weights(hidden), cdt),
            k3.pack_head_weights(self.EquivariantMLP_0, self.irreps_out, S, V, cdt),
        )

    def _stack_args(self, batch: GraphBatch, nf0, c_noise, radial_cutoff: float) -> tuple:
        """The arguments of `e3conv_stack` (and of its plain version) for the
        forward after the noise-scaled embedding nf0. Each layer's noise
        scale and skip weight come from the layer's own predictor modules,
        so this path cannot drift from the layerwise one."""
        f32, cdt = torch.float32, self.dtype or torch.float32
        layers = self._hidden_layers()
        scales = torch.stack(
            [layer.NoiseConditionalScaling_0._ScalePredictor_0(c_noise) for layer in layers]
        )
        skipw = torch.sigmoid(torch.stack(
            [layer.NoiseConditionalSkipConnection_0._ScalePredictor_0(c_noise) for layer in layers]
        ))
        proj_w, layers_w, head_w = self._stack_weights(cdt)
        return (
            batch.pos.to(f32).contiguous(), batch.node_mask, batch.bond_src, batch.bond_dst,
            batch.bond_mask, radial_cutoff, nf0.to(f32).contiguous(), proj_w, layers_w,
            scales.to(f32).contiguous(), skipw.to(f32).contiguous(), head_w,
            self.radial_dim, cdt,
        )

    def forward(
        self,
        batch: GraphBatch,
        c_noise: torch.Tensor,
        radial_cutoff: float,
        nbr_cache=None,
        with_telemetry: bool = False,
    ):
        """batch.pos are the scaled noisy positions (c_in * y); c_noise [1];
        `nbr_cache` = (nbr_idx, superset_mask), a Verlet list of the walk,
        read only on the sparse path. Returns the per-atom output irreps
        [G, N, irreps_out.dim], and with `with_telemetry` also a dict
        ({"neighbor_overflow": [G]} where the sparse path built its lists)."""
        N = batch.pos.shape[1]
        on_card = batch.pos.device.type == "cuda"
        if self.atom_axis is not None:
            out, tel = self.sharded_forward(batch, c_noise, radial_cutoff, resolve_group(self.atom_axis))
            return (out, tel) if with_telemetry else out
        if self.plain and on_card:
            raise ValueError(
                "plain=True (use_pallas=False) is the CPU reference path; the card runs the kernels"
            )
        wants_grad = self._wants_grad(batch)
        tel = {}
        if self.neighbor_mode == "nbr" or (
            self.neighbor_mode == "auto" and neighbor_mode_auto(N, wants_grad)
        ):
            kernel = self.kernels and not wants_grad
            edges, overflow = self._sparse_edges(batch, radial_cutoff, nbr_cache, kernel)
            out = self._standard_forward(batch, c_noise, edges, kernel)
            if overflow is not None:
                tel["neighbor_overflow"] = overflow
        elif self.pallas_variant == "plane":
            kernel = self.kernels and not wants_grad
            out = self._standard_forward(batch, c_noise, self._plain_edges(batch, radial_cutoff), kernel)
        else:
            out = self._dense_forward(batch, c_noise, radial_cutoff, wants_grad)
        return (out, tel) if with_telemetry else out

    def sharded_forward(self, batch: GraphBatch, c_noise, radial_cutoff, group):
        """The atom-sharded forward of this rank's destination rows over the
        process group `group` (`jamun_tpu/models/e3conv.py:186-206`):
        positions and mask gathered from every rank, each row's global index
        for the self-pair, "auto" decided on the whole molecule, the plain
        path throughout. `group` None is the single process, whose rows are
        the whole molecule and whose gathers are identities (JAX's one-device
        mesh). Returns (out, telemetry)."""
        G, n_loc = batch.pos.shape[:2]
        rank, world = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))
        sharded = dict(
            src_pos=gather_halo(batch.pos, group, 1),
            src_mask=all_gather(batch.node_mask, group, 1),
            dst_index=(rank * n_loc + torch.arange(n_loc, device=batch.pos.device)).expand(G, n_loc),
        )
        n_total = n_loc * world
        tel = {}
        if self.neighbor_mode == "nbr" or (
            self.neighbor_mode == "auto" and neighbor_mode_auto(n_total, self._wants_grad(batch))
        ):
            edges, overflow = neighbor_edge_data(
                batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask,
                radial_cutoff, functools.partial(spherical_harmonics, self.irreps_sh),
                self._attr_fn(radial_cutoff), cap=self.neighbor_cap,
                bond0_embed=self.embed_bondedness[0], **sharded,
            )
            tel["neighbor_overflow"] = overflow
        else:
            edges = self._plain_edges(batch, radial_cutoff, **sharded)
        edges = dataclasses.replace(edges, atom_axis=group)
        return self._standard_forward(batch, c_noise, edges, False), tel

    def _embed(self, batch: GraphBatch, c_noise: torch.Tensor) -> torch.Tensor:
        return self.NoiseConditionalScaling_0(self.embedder(batch), c_noise)

    def _standard_forward(self, batch, c_noise, edges, kernel: bool):
        """Every ConvBlock the standard block on `edges`, `kernel` passed to
        each `Conv`, and the plain head: the sparse path, and the dense path
        under `pallas_variant="plane"`."""
        block = lambda blk, h: blk(h, edges, kernel)  # noqa: E731
        x = block(self.ConvBlock_0, self._embed(batch, c_noise))
        for layer in self._hidden_layers():
            x = layer(x, c_noise, block)
        x = self.EquivariantMLP_0(x)
        mask = batch.node_mask[..., None].to(torch.float32)
        return x.to(torch.float32) * self.output_gain * mask

    def _sparse_edges(self, batch: GraphBatch, radial_cutoff, nbr_cache, kernel: bool):
        """The kept edges of one forward: K7's features on a cached list
        when `nbr_geom_kernel` asks for them on the kernel path (the
        radial half of the attributes, the bondedness-0 block left for
        `Conv` to fold), else `neighbor_edge_data`. Returns (EdgeData,
        overflow or None)."""
        bond0 = self.embed_bondedness[0]
        bonds = (batch.bond_src, batch.bond_dst, batch.bond_mask)
        sh_fn = functools.partial(spherical_harmonics, self.irreps_sh)
        attr_fn = self._attr_fn(radial_cutoff)
        if kernel and self.nbr_geom_kernel and nbr_cache is not None:
            cdt = self.dtype or torch.float32
            sh, rad, mask, idx = nbr_edge_features(
                batch.pos.to(torch.float32).contiguous(), nbr_cache[0], nbr_cache[1],
                float(radial_cutoff), self.radial_dim, cdt,
            )
            edges = dense_edge_data(
                batch.pos, batch.node_mask, *bonds, radial_cutoff, sh_fn, attr_fn, dense=False
            )
            return dataclasses.replace(
                edges, nbr_idx=idx, nbr_mask=mask, sh_nbr=sh, attr_nbr=rad, bond0_embed=bond0
            ), None
        return neighbor_edge_data(
            batch.pos, batch.node_mask, *bonds, radial_cutoff, sh_fn, attr_fn,
            cap=self.neighbor_cap, bond0_embed=bond0, cache=nbr_cache,
        )

    def _dense_forward(self, batch, c_noise, radial_cutoff, wants_grad):
        N = batch.pos.shape[1]
        on_card = batch.pos.device.type == "cuda"
        stack = self._stack_ok(batch, c_noise)
        supported = self.kernels and self.kernel_path_supported(N)
        # the training dispatch (JAX's `e3conv.py:333-338`): a call that wants
        # a gradient above 128 atoms takes the plain path wholesale, unless
        # `tiled_kernel_training` lets it take K5 with its recomputed backward
        kernels = self.kernels and supported and not (
            wants_grad and N > EDGE_FEATURE_ATOMS and not self.tiled_kernel_training
        )
        if on_card and self.kernels and not supported:
            raise NotImplementedError(
                f"N={N}, edge_attr_dim={self.edge_attr_dim}, hidden {self.irreps_hidden}, "
                f"output {self.irreps_out}: outside the layerwise kernels (edge_attr_dim 64, "
                f"radial width <= {k2.MAX_WIDTH}); see "
                "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
            )
        x = self._embed(batch, c_noise)
        mask = batch.node_mask[..., None].to(torch.float32)
        if stack:
            x = k3.e3conv_stack(*self._stack_args(batch, x, c_noise, float(radial_cutoff)))
            return x * self.output_gain * mask
        if kernels:
            block = self._kernel_block(batch, float(radial_cutoff))
        else:
            edges = self._plain_edges(batch, radial_cutoff)
            block = lambda blk, h: blk(h, edges)  # noqa: E731
        x = block(self.ConvBlock_0, x)
        for layer in self._hidden_layers():
            x = layer(x, c_noise, block)
        x = self._kernel_head(x) if kernels else self.EquivariantMLP_0(x)
        return x.to(torch.float32) * self.output_gain * mask

    def _kernel_head(self, x: torch.Tensor) -> torch.Tensor:
        """The EquivariantMLP head with the rounding points of JAX's
        `_transposed_head` (`jamun_tpu/models/e3conv.py:649-692`): inputs cast
        to the compute dtype, each IrrepsLinear kernel cast and then scaled by
        1/sqrt(fan-in), products, sigmoid, leaky-ReLU and gate in the compute
        dtype. The activations are written as XLA evaluates them: the sigmoid
        as 1 / (1 + exp(-t)) op by op, the leaky-ReLU slope rounded to the
        compute dtype. Returns [G, N, irreps_out.dim] in the compute dtype."""
        cdt = self.dtype or torch.float32
        S, V = self.irreps_hidden.sv_shape()
        G, N = x.shape[:2]
        blk = self.EquivariantMLP_0.EquivariantMLPBlock_0.IrrepsLinear_0
        fin = self.EquivariantMLP_0.IrrepsLinear_0

        def lin(w, fan, h):  # the divisor rounded to cdt, as JAX's weak typing does
            return h @ (w.to(cdt) / k2.rounded_divisor(math.sqrt(max(fan, 1)), cdt, h.device))

        xs = x[..., :S].to(cdt)
        xv = x[..., S:].reshape(G, N, V, 3).transpose(-1, -2).to(cdt)  # [G, N, 3, V]
        s_pre = lin(blk.weight(0, 0), S, xs)
        s_act = torch.where(s_pre >= 0, s_pre, s_pre * torch.tensor(0.01, dtype=cdt))
        gates = xla_sigmoid(lin(blk.weight(0, 1), S, xs))
        gated = lin(blk.weight(1, 2), V, xv) * gates[:, :, None]
        parts = []
        for j, mi in enumerate(self.irreps_out):
            if mi.ir.l == 0:
                parts.append(lin(fin.weight(0, j), S, s_act))
            else:
                o = lin(fin.weight(1, j), V, gated)  # [G, N, 3, mul]
                parts.append(o.transpose(-1, -2).reshape(G, N, 3 * mi.mul))
        return torch.cat(parts, -1)

    def _kernel_block(self, batch: GraphBatch, radial_cutoff: float):
        """The per-forward geometry every ConvBlock shares, in the regime of
        this call's atom count: up to 128 atoms K1's edge features (for K2),
        above that only the positions and bonds (K5 rebuilds the rest)."""
        cdt = self.dtype or torch.float32
        pos = batch.pos.to(torch.float32).contiguous()
        bonds = (batch.bond_src, batch.bond_dst, batch.bond_mask)
        if pos.shape[1] <= EDGE_FEATURE_ATOMS:
            ef, bf = edge_features(pos, batch.node_mask, *bonds, radial_cutoff, self.radial_dim, cdt)
            geometry = k2.PairFeatures(ef, bf, batch.bond_src, batch.bond_dst)
        else:
            geometry = k5.tiled_geometry_inputs(
                pos, batch.node_mask, *bonds, radial_cutoff, self.radial_dim
            )
        bond0, bond1 = self.embed_bondedness[0], self.embed_bondedness[1]
        return lambda blk, h: blk.fused(h, geometry, bond0, bond1, cdt)

    def _attr_fn(self, radial_cutoff):
        """attr_fn(dist, bonded) -> [..., edge_attr_dim]: the bondedness
        embedding beside the radial basis."""

        def attr_fn(dist, bonded: bool):
            radial = soft_one_hot_linspace(dist, 0.0, radial_cutoff, self.radial_dim)
            bond = self.embed_bondedness[1 if bonded else 0].to(dist.dtype)
            return torch.cat([bond.expand(dist.shape + (self.bonded_dim,)), radial], dim=-1)

        return attr_fn

    def _plain_edges(self, batch: GraphBatch, radial_cutoff, **sharded):
        return dense_edge_data(
            batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask,
            radial_cutoff, functools.partial(spherical_harmonics, self.irreps_sh),
            self._attr_fn(radial_cutoff), bond0_embed=self.embed_bondedness[0],
            bond1_embed=self.embed_bondedness[1], **sharded,
        )

