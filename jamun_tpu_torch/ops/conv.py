"""Equivariant graph convolution on dense padded batches.

Counterpart of `jamun_tpu/ops/conv.py` (`Conv`, `SeparableConv`,
`ExperimentalConv` and `ConvBlock`). Per edge: the tensor product of the
source features, the edge SH and the radial-MLP weights; mean over the
combined degree of dense pairs and bonds. `ConvBlock` wraps it as
IrrepsLinear_1(Gate(Conv_0(x))) + IrrepsLinear_0(x).

`tensor_product` is JAX's: "uvu", the separable product (`depthwise_tp`,
then the post-linear), "uvw", e3nn's fully connected product, or
"experimental", the full product and an externally weighted linear
(`ops/experimental_tp.py`); the last two have no post-linear. The uvu
product of `Sx0e (+ Vx1e)` with `1x0e + 1x1e` is JAX's fast shape
(`_fast_uvu_supported`, `jamun_tpu/ops/conv.py:175-183`): its messages come
from the closed form of `ops/fast_uvu.py`, on the kernels below where the
caller allows them. Every other product, uvu of any l included, runs
the library ops on either device, as every kernel route of JAX's `Conv` is
gated on the fast uvu shape: the radial MLP's weights per uvw group or
path (`_path_weights`) and the product, on the live radial pairs alone
(`_tp_messages`, `ops/graph.live_pairs`), where JAX's generic path computes
every slot and masks the sum (`jamun_tpu/ops/conv.py:253-262, 353-364`).

`Conv.forward(x, edges, kernel)`: the caller sets `kernel` for a call that
may take the hand-written kernels (on the card; their plain twins on the
CPU), as JAX's `use_pallas` / `nbr_kernel`. On the sparse capped-neighbour
path (`EdgeData.nbr_idx` set, from `ops/neighbors.py`) the messages of the
kept edges then come from K6 (`ops/cuda/nbr_conv`), and from
`fast_uvu_messages_nbr` on the radial MLP otherwise; bonds, the mean and the
post-linear follow as on the dense path (`jamun_tpu/ops/conv.py:198-265`).
In the atom-sharded mode (`EdgeData.atom_axis` set, by `E3Conv(atom_axis=
...)`) the source features are all-gathered once per layer
(`parallel.mesh.gather_halo`, whose backward is a reduce-scatter), the
destination rows stay this rank's, and no kernel runs, as JAX's gates
(`jamun_tpu/ops/conv.py:125,154,193-196`).
On the dense path `Conv.dense_route` picks what JAX's `Conv.__call__` picks
(`jamun_tpu/ops/conv.py:266-342`): under `pallas_variant="packed"` K2's layer
mode (`conv_layer`: pairs, bonds, mean and post-linear in one launch) when
the fused layer applies, else K8 (`ops/cuda/dense_conv.packed_uvu_conv_dense`);
under `"plane"` K9 (`fused_uvu_conv_dense`) for V > 0. After K8 or K9 the
bonds, the mean and the post-linear run as on the plain path
(`jamun_tpu/ops/conv.py:366-377`).

`ConvBlock.forward` is the plain path. `ConvBlock.fused` runs the whole block
through the hand-written kernels on the card (their plain twins on the CPU),
in the regime its geometry argument names, as JAX's `ConvBlock._fused_block`
does: on `PairFeatures` (up to 128 atoms) `fused_conv_block` (K2) when no
gradient is wanted and `conv_block_trainable` (K2 forward, K4 backward) when
one is; on `TiledGeometry` (any size) `fused_block_tiled` (K5), and when a
gradient is wanted `fused_block_tiled_trainable` (K5 forward, the recomputed
backward of JAX's `make_trainable_conv_block_v2`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from jamun_tpu_torch.ops.cuda.conv_block import (
    N_RADIAL,
    PairFeatures,
    block_master_weights,
    cast_block_weights,
    conv_block_trainable,
    conv_layer,
    fused_conv_block,
    layer_weights,
)
from jamun_tpu_torch.ops.cuda.dense_conv import fused_uvu_conv_dense, packed_uvu_conv_dense
from jamun_tpu_torch.ops.cuda.edge_features import edge_features
from jamun_tpu_torch.ops.cuda.fused_block_tiled import (
    TiledGeometry,
    fused_block_tiled,
    fused_block_tiled_trainable,
)
from jamun_tpu_torch.ops.cuda.nbr_conv import nbr_uvu_conv
from jamun_tpu_torch.ops.experimental_tp import ExperimentalTensorProduct
from jamun_tpu_torch.ops.fast_uvu import (
    fast_uvu_messages_dense,
    fast_uvu_messages_nbr,
    uvu_messages,
)
from jamun_tpu_torch.ops.gate import Gate
from jamun_tpu_torch.ops.graph import EdgeData, edge_pairs
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.linear import IrrepsLinear
from jamun_tpu_torch.ops.mlp import ScalarMLP
from jamun_tpu_torch.ops.sh import SH_IRREPS
from jamun_tpu_torch.parallel.mesh import gather_halo
from jamun_tpu_torch.ops.tensor_product import depthwise_tp, fully_connected_tp

__all__ = [
    "Conv", "SeparableConv", "ExperimentalConv", "ConvBlock", "depthwise_irreps",
    "takes_pair_list", "PALLAS_VARIANTS", "TENSOR_PRODUCTS",
]

PALLAS_VARIANTS = ("packed", "plane")  # JAX's `pallas_variant`
TENSOR_PRODUCTS = ("uvu", "uvw", "experimental")  # JAX's `tensor_product`


def check_tensor_product(tensor_product: str) -> None:
    if tensor_product not in TENSOR_PRODUCTS:
        raise ValueError(f"tensor_product={tensor_product!r}")


def depthwise_irreps(irreps_in, irreps_out):
    """The dtp irreps of the fast uvu shape, the product of `Sx0e (+ Vx1e)`
    with `1x0e + 1x1e` restricted to irreps_out plus scalars, in the closed
    form's block order [Sx0e, Sx1e(, Vx1e, Vx0e, Vx1e)]; None when the
    shape is not that one (or irreps_out lacks 1e or has 2e, where
    `depthwise_tp` makes other blocks)."""
    sv = Irreps(irreps_in).sv_shape()
    if sv is None or "1e" not in Irreps(irreps_out) or "2e" in Irreps(irreps_out):
        return None
    S, V = sv
    blocks = [(S, "0e"), (S, "1e")]
    if V:
        blocks += [(V, "1e"), (V, "0e"), (V, "1e")]
    return Irreps(blocks)


def takes_pair_list(model: nn.Module) -> bool:
    """Whether a `Conv` of `model` computes its messages on the live pairs
    (`Conv._tp_messages`): a product without the fast uvu shape."""
    return any(isinstance(m, Conv) and not m.fast_uvu for m in model.modules())


class Conv(nn.Module):
    """Tensor-field-network convolution with the depthwise (uvu), the fully
    connected (uvw) or the experimental product."""

    def __init__(
        self, irreps_in, irreps_out, irreps_sh, edge_attr_dim: int, dtype=None,
        pallas_variant: str = "packed", tensor_product: str = "uvu",
    ):
        super().__init__()
        if pallas_variant not in PALLAS_VARIANTS:
            raise ValueError(f"pallas_variant={pallas_variant!r}")
        check_tensor_product(tensor_product)
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        self.irreps_sh = Irreps(irreps_sh)
        self.S, self.V = self.irreps_in.sv_shape() or (0, 0)
        self.dtype = dtype
        self.edge_attr_dim = edge_attr_dim
        self.pallas_variant = pallas_variant
        self.tensor_product = tensor_product
        if tensor_product == "uvw":
            self.tp = fully_connected_tp(self.irreps_in, self.irreps_sh, self.irreps_out)
        elif tensor_product == "experimental":
            self.tp = ExperimentalTensorProduct(self.irreps_in, self.irreps_sh, self.irreps_out)
        else:
            self.tp, dtp = depthwise_tp(self.irreps_in, self.irreps_sh, self.irreps_out)
        # the closed-form messages of `ops/fast_uvu.py` (and the kernels):
        # JAX's `_fast_uvu_supported`, where `depthwise_tp` makes the blocks
        # of the closed form
        self.fast_uvu = (
            tensor_product == "uvu" and self.irreps_sh == SH_IRREPS
            and depthwise_irreps(self.irreps_in, self.irreps_out) == self.tp.irreps_out
        )
        # registered before the post-linear: `reset_parameters` draws the
        # modules' weights in this order from one generator
        self.radial_nn = ScalarMLP(edge_attr_dim, self.tp.weight_numel, [edge_attr_dim])
        self._post_linear = IrrepsLinear(dtp, self.irreps_out) if tensor_product == "uvu" else None

    def forward(self, x: torch.Tensor, edges: EdgeData, kernel: bool = False) -> torch.Tensor:
        """x [G, N, irreps_in.dim] -> [G, N, irreps_out.dim]. `kernel`: the
        caller allows the kernels (no gradient flows through them); on the
        sparse path K6, on the dense path what `dense_route` picks. A product
        other than the fast uvu shape has no kernel and ignores it."""
        S, V = self.S, self.V
        cdt = self.dtype or x.dtype
        out_dtype = x.dtype
        x = x.to(cdt)
        # the atom-sharded halo: the sources are the whole gathered molecule,
        # the destination rows (and the output) this rank's
        src = x if edges.atom_axis is None else gather_halo(x, edges.atom_axis, 1)
        if edges.atom_axis is not None:
            kernel = False  # JAX gates every kernel off under an atom axis
        if not self.fast_uvu:
            out, deg = self._tp_messages(src, edges, out_dtype)
        elif edges.nbr_idx is None:
            route = self.dense_route(x, edges) if kernel else "plain"
            if route == "conv_layer":
                return self._kernel_layer(x, edges).to(out_dtype)
            if route == "plain":
                w_dense = self.radial_nn(edges.attr_dense.to(cdt))
                out, deg = fast_uvu_messages_dense(src, edges.sh_dense, w_dense, edges.adj, S, V)
            else:
                fn = packed_uvu_conv_dense if route == "packed_uvu_conv_dense" else fused_uvu_conv_dense
                d0, d1 = self.radial_nn.layer(0), self.radial_nn.layer(1)
                out, deg = fn(
                    edges.pos.to(torch.float32).contiguous(), edges.node_mask, x.contiguous(),
                    d0.kernel, d0.bias, d1.kernel, d1.bias, edges.bond0_embed,
                    edges.radial_cutoff, S, V,
                )
        elif kernel:
            out, deg = nbr_uvu_conv(*self.nbr_kernel_args(x, edges))
        else:
            if edges.attr_nbr.shape[-1] != self.radial_nn.layer(0).kernel.shape[0]:
                raise RuntimeError(
                    "radial-only neighbour features (nbr_edge_features) need the K6 path"
                )
            w_nbr = self.radial_nn(edges.attr_nbr.to(cdt))
            out, deg = fast_uvu_messages_nbr(
                src, edges.sh_nbr, w_nbr, edges.nbr_idx, edges.nbr_mask, S, V
            )
        out, deg = out.to(out_dtype), deg.to(torch.float32)

        src_b = torch.gather(src, 1, edges.bond_src[..., None].expand(-1, -1, src.shape[-1]))
        if not self.fast_uvu:
            msg_b = self.tp(src_b, edges.sh_bond.to(cdt), self._path_weights(edges.attr_bond.to(cdt)))
        else:
            msg_b = uvu_messages(src_b, edges.sh_bond, self.radial_nn(edges.attr_bond.to(cdt)), S, V)
        msg_b = msg_b.to(out_dtype) * edges.bond_mask[..., None].to(out_dtype)
        dst = edges.bond_dst[..., None]
        out = out.scatter_add(1, dst.expand(-1, -1, msg_b.shape[-1]), msg_b)
        deg = deg.scatter_add(1, edges.bond_dst, edges.bond_mask.to(torch.float32))
        out = out / torch.clamp(deg, min=1.0)[..., None].to(out_dtype)
        return out if self._post_linear is None else self._post_linear(out)

    def _path_weights(self, attr: torch.Tensor) -> list:
        """The radial MLP's `tp.weight_numel` outputs, one tensor per weight
        entry of `self.tp`: the last Dense layer runs on each entry's
        columns, a uvw group's gathered in the product's [w, U] order
        (`WeightedTensorProduct.weight_groups`), the experimental product's
        a path's slice. The same numbers as JAX's one output split at the
        paths, but no tensor of every path's weights is made, nor in the
        backward a gradient of that size for each entry's part of it: at
        the flagship width a pair carries 28992 weights (uvw and
        experimental alike)."""
        if self.tensor_product == "experimental":
            return self.radial_nn.split_forward(attr, self.tp.weight_slices())
        return self.radial_nn.split_forward(attr, self.tp.weight_groups(attr.device))

    def _tp_messages(self, src: torch.Tensor, edges: EdgeData, out_dtype):
        """The summed messages and the degree of the radial edges through
        `self.tp` (any product but the fast uvu shape) from the source
        features `src`, on the live pairs alone: those `edges.pairs` holds,
        else compacted here (`ops/graph.edge_pairs`). Either layout, dense
        or capped (JAX's generic paths, `jamun_tpu/ops/conv.py:253-262,
        353-364`, which compute every slot and mask the sum), gives the
        same steps: each pair's source row, radial weights and message,
        then a segment sum over the dst-major rows, deterministic on either
        device. A slot the mask drops adds an exact 0 there, so only the
        order of the f32 sums differs. The sums accumulate in `out_dtype`,
        as `preferred_element_type` asks there."""
        cdt = src.dtype
        G, N_src, D = src.shape
        pairs = edges.pairs if edges.pairs is not None else edge_pairs(edges, N_src)
        mask = edges.adj if edges.nbr_idx is None else edges.nbr_mask
        w = self._path_weights(pairs.attr.to(cdt))  # [P, *] per weight entry
        msg = self.tp(src.reshape(-1, D)[pairs.src], pairs.sh.to(cdt), w)
        out = torch.segment_reduce(msg.to(out_dtype), "sum", lengths=pairs.rows, unsafe=True)
        return out.reshape(G, mask.shape[1], -1), mask.sum(-1)

    def _wants_grad(self, x: torch.Tensor, edges: EdgeData) -> bool:
        inputs = (x, edges.pos, edges.bond0_embed, edges.bond1_embed)
        return torch.is_grad_enabled() and (
            any(t is not None and t.requires_grad for t in inputs)
            or any(p.requires_grad for p in self.parameters())
        )

    def _fused_layer_supported(self, edges: EdgeData) -> bool:
        """JAX's `_fused_layer_supported` (`jamun_tpu/ops/conv.py:137-145`):
        the bondedness-1 row, and an irreps_out that is all l <= 1 of even
        parity with at least one 0e block (the uvu product always has its
        post-linear)."""
        return (
            edges.bond1_embed is not None
            and all(mi.ir.l in (0, 1) and mi.ir.p == 1 for mi in self.irreps_out)
            and any(mi.ir.l == 0 for mi in self.irreps_out)
        )

    def dense_route(self, x: torch.Tensor, edges: EdgeData) -> str:
        """Which way a dense call with `kernel` set goes, by JAX's gates
        (`Conv._pallas_supported` and `__call__`, `jamun_tpu/ops/conv.py
        :93-135, 266-342`): "conv_layer" (K2's layer mode), "packed_uvu_conv_dense"
        (K8), "fused_uvu_conv_dense" (K9) or "plain". Where JAX's gate sends
        the call to XLA, the plain path runs: a product other than the fast
        uvu shape (uvw, experimental, an input that is not `Sx0e (+ Vx1e)`,
        harmonics other than `1x0e + 1x1e`), edge attributes other than 64
        wide (`supports_packed_conv` / `supports_fused_conv`), no
        positions or bondedness-0 row in `edges`, V = 0 under "plane"
        (`supports_fused_conv` needs V > 0), and a call that wants a gradient
        (JAX has no VJP for #8 or #9; its training dispatch keeps such calls
        off them). That is JAX's behaviour, not a fallback: where this gate
        says "kernel", a shape the port's kernel cannot take raises on the
        card."""
        sv = self.irreps_in.sv_shape()
        if (
            not self.fast_uvu or sv[0] == 0 or self.edge_attr_dim != 2 * N_RADIAL
            or edges.pos is None or edges.bond0_embed is None
            or self._wants_grad(x, edges)
        ):
            return "plain"
        if self.pallas_variant == "plane":
            return "fused_uvu_conv_dense" if sv[1] > 0 else "plain"
        return "conv_layer" if self._fused_layer_supported(edges) else "packed_uvu_conv_dense"

    def _kernel_layer(self, x: torch.Tensor, edges: EdgeData) -> torch.Tensor:
        """K2's layer mode on K1's edge features: those `edges` carries, or
        made here with K1 (`jamun_tpu/ops/conv.py:279-294`)."""
        cdt = x.dtype
        if edges.pair_features is not None:
            ef, bf = edges.pair_features
        else:
            ef, bf = edge_features(
                edges.pos.to(torch.float32).contiguous(), edges.node_mask, edges.bond_src,
                edges.bond_dst, edges.bond_mask > 0, edges.radial_cutoff, N_RADIAL, cdt,
            )
        w = layer_weights(
            self.radial_nn, self._post_linear, edges.bond0_embed, edges.bond1_embed,
            S=self.S, V=self.V, cdt=cdt,
        )
        return conv_layer(x.contiguous(), ef, bf, edges.bond_src, edges.bond_dst, w)

    def nbr_kernel_args(self, x: torch.Tensor, edges: EdgeData) -> tuple:
        """K6's arguments for the kept edges of `edges`, x in the compute
        dtype: the radial MLP's weights in the kernel's operand types. With
        radial-only attributes (`nbr_edge_features`) the constant
        bondedness-0 block of the first layer folds into its bias in f32, as
        JAX's `Conv` does (`jamun_tpu/ops/conv.py:212-224`)."""
        f32, cdt = torch.float32, x.dtype
        d0, d1 = self.radial_nn.layer(0), self.radial_nn.layer(1)
        w1, b1 = d0.kernel, d0.bias.to(f32)
        nb = w1.shape[0] - edges.attr_nbr.shape[-1]
        if nb:
            b1 = b1 + edges.bond0_embed.to(f32) @ w1[:nb].to(f32)
            w1 = w1[nb:]
        return (
            x.contiguous(), edges.sh_nbr.to(cdt).contiguous(), edges.attr_nbr.to(cdt).contiguous(),
            edges.nbr_idx.contiguous(), edges.nbr_mask.to(f32).contiguous(),
            w1.to(cdt).contiguous(), b1.contiguous(), d1.kernel.to(cdt).contiguous(),
            d1.bias.to(f32).contiguous(), self.S, self.V,
        )


class SeparableConv(Conv):
    """`Conv` with the depthwise product and its post-linear (JAX's
    `SeparableConv`)."""

    def __init__(self, irreps_in, irreps_out, irreps_sh, edge_attr_dim: int, dtype=None,
                 pallas_variant: str = "packed"):
        super().__init__(irreps_in, irreps_out, irreps_sh, edge_attr_dim, dtype, pallas_variant, "uvu")


class ExperimentalConv(Conv):
    """`Conv` with the full product and the externally weighted linear
    (JAX's `ExperimentalConv`)."""

    def __init__(self, irreps_in, irreps_out, irreps_sh, edge_attr_dim: int, dtype=None,
                 pallas_variant: str = "packed"):
        super().__init__(
            irreps_in, irreps_out, irreps_sh, edge_attr_dim, dtype, pallas_variant, "experimental"
        )


class ConvBlock(nn.Module):
    """LinearSelfInteraction(Gated(Conv)): IrrepsLinear_1(gate(Conv_0(x))) +
    IrrepsLinear_0(x)."""

    def __init__(
        self, irreps_in, irreps_out, irreps_sh, edge_attr_dim: int, dtype=None,
        pallas_variant: str = "packed", tensor_product: str = "uvu",
    ):
        super().__init__()
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        self.gate = Gate(self.irreps_out)
        self.dtype = dtype
        self.Conv_0 = Conv(
            irreps_in, self.gate.irreps_in, irreps_sh, edge_attr_dim, dtype, pallas_variant,
            tensor_product,
        )
        self.IrrepsLinear_0 = IrrepsLinear(self.irreps_in, self.gate.irreps_out)
        self.IrrepsLinear_1 = IrrepsLinear(self.gate.irreps_out, self.gate.irreps_out)

    def forward(self, x: torch.Tensor, edges: EdgeData, kernel: bool = False) -> torch.Tensor:
        """The standard block; `kernel` is `Conv.forward`'s."""
        skip = self.IrrepsLinear_0(x)
        y = self.IrrepsLinear_1(self.gate(self.Conv_0(x, edges, kernel)))
        return y + skip

    def fused(
        self,
        x: torch.Tensor,
        geometry: Union[PairFeatures, TiledGeometry],
        bond0: torch.Tensor,
        bond1: torch.Tensor,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """The whole block on the per-forward geometry of either regime:
        `PairFeatures` (the edge features of `ops/cuda/edge_features`, up to
        128 atoms) or `TiledGeometry` (`tiled_geometry_inputs`, any size).
        Returns f32 [G, N, Sc + 3Vg]. On `PairFeatures` it is differentiable
        in x, the block's parameters and bond0/bond1 when autograd asks for
        it, on either geometry (the model sends a call that wants a gradient
        above 128 atoms here only under `tiled_kernel_training`)."""
        cdt = compute_dtype or x.dtype
        conv = self.Conv_0
        masters = block_master_weights(
            conv.radial_nn, conv._post_linear, self.IrrepsLinear_1, self.IrrepsLinear_0,
            bond0, bond1, S=conv.S, V=conv.V,
        )
        x = x.to(cdt).contiguous()
        wants_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in masters.tensors())
        )
        if isinstance(geometry, TiledGeometry):
            if wants_grad:
                return fused_block_tiled_trainable(x, geometry, masters)
            return fused_block_tiled(x, geometry, cast_block_weights(masters, cdt))
        if wants_grad:
            return conv_block_trainable(x, *geometry, masters)
        return fused_conv_block(x, *geometry, cast_block_weights(masters, cdt))
