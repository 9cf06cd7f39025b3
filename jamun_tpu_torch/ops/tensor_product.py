"""Weighted Clebsch-Gordan tensor products on packed irreps tensors
(counterpart of `jamun_tpu/ops/tensor_product.py:28-143`).

Paths are built once, at construction; the call runs three einsums per
path, the small CG contraction first (x2 with C, then x1: the order
opt_einsum picks, written out so that no call searches for it on the host):

    t[..., u, v, k] = sum_{i,j} C[i,j,k] x1[..., u, i] x2[..., v, j]
    out[..., w, k]  = path_weight * sum_{u,v} W[..., u, v, w] t[..., u, v, k]

`fully_connected_tp` is e3nn's FullyConnectedTensorProduct with external,
unshared weights (the "uvw" product of `Conv`); `depthwise_tp` the
depthwise "uvu" product of any l (`jamun_tpu/ops/tensor_product.py:
145-198`), whose outputs a post-linear mixes. Normalization follows e3nn's
normalization="component", path_normalization="element". There is no
hand-written kernel behind either, as there is none in JAX: XLA computes
these einsums there. `scale_irreps` multiplies each irrep copy by a scalar.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from jamun_tpu_torch.ops.cg import real_wigner_3j
from jamun_tpu_torch.ops.irreps import Irreps

__all__ = [
    "WeightedTensorProduct", "fully_connected_tp", "depthwise_tp", "scale_irreps",
    "scale_irreps_transposed",
]


@dataclasses.dataclass(frozen=True)
class Instruction:
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # "uvw" | "uvu"
    path_weight: float
    weight_offset: int
    weight_shape: Tuple[int, ...]


class WeightedTensorProduct:
    """A bilinear equivariant map (x1, x2, weights) -> out; the weights
    (`weight_numel` per element) come at call time, from a radial MLP in the
    conv layers."""

    def __init__(
        self,
        irreps_in1: Union[str, Irreps],
        irreps_in2: Union[str, Irreps],
        irreps_out: Union[str, Irreps],
        instructions: Optional[Sequence[Tuple[int, int, int, str]]] = None,
    ):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)

        if instructions is None:
            # fully connected: every allowed (i1, i2) -> i3 path, mode uvw
            instructions = [
                (i1, i2, i3, "uvw")
                for i1, mi1 in enumerate(self.irreps_in1)
                for i2, mi2 in enumerate(self.irreps_in2)
                for i3, mi3 in enumerate(self.irreps_out)
                if mi3.ir in mi1.ir * mi2.ir
            ]

        # "element" path normalization: the fan-in counts elements over all
        # paths that write into the same output block
        fan_in = [0.0] * len(self.irreps_out)
        for i1, i2, i3, mode in instructions:
            mul1, mul2 = self.irreps_in1[i1].mul, self.irreps_in2[i2].mul
            if mode == "uvw":
                fan_in[i3] += mul1 * mul2
            elif mode == "uvu":
                fan_in[i3] += mul2
            else:
                raise ValueError(mode)

        self.instructions: List[Instruction] = []
        offset = 0
        for i1, i2, i3, mode in instructions:
            mul1, mul2, mul3 = self.irreps_in1[i1].mul, self.irreps_in2[i2].mul, self.irreps_out[i3].mul
            if mode == "uvw":
                wshape = (mul1, mul2, mul3)
            else:
                if mul3 != mul1:
                    raise ValueError(f"uvu requires out mul == in1 mul ({mul3} vs {mul1})")
                wshape = (mul1, mul2)
            # C is scaled by sqrt(d3) at call time so that sum_ij C'[i,j,k]^2 = 1;
            # unit output variance then needs path_weight = 1/sqrt(fan_in)
            pw = math.sqrt(1.0 / fan_in[i3]) if fan_in[i3] > 0 else 0.0
            self.instructions.append(Instruction(i1, i2, i3, mode, pw, offset, wshape))
            offset += int(np.prod(wshape))
        self.weight_numel = offset
        # (l1, l2, l3, dtype, device) -> the scaled CG tensor, made once per
        # device: a host tensor copied at every call would make the host wait
        self._cg = {}

    def _coupling(self, l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
        key = (l1, l2, l3, like.dtype, like.device)
        if key not in self._cg:
            cg = real_wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
            self._cg[key] = torch.as_tensor(cg, dtype=like.dtype, device=like.device)
        return self._cg[key]

    def weight_slices(self) -> List[slice]:
        """Each path's slice of the `weight_numel` weights, in path order."""
        return [
            slice(ins.weight_offset, ins.weight_offset + int(np.prod(ins.weight_shape)))
            for ins in self.instructions
        ]

    def __call__(
        self, x1: torch.Tensor, x2: torch.Tensor, weights: Union[torch.Tensor, Sequence[torch.Tensor]]
    ) -> torch.Tensor:
        """x1 [..., irreps_in1.dim], x2 [..., irreps_in2.dim], weights
        [..., weight_numel] (per element) or [weight_numel] (shared), or the
        same split at `weight_slices` (one tensor per path); computed in
        x1's dtype."""
        batch_shape = x1.shape[:-1]
        sl1, sl2 = self.irreps_in1.slices(), self.irreps_in2.slices()
        out_blocks = [None] * len(self.irreps_out)
        if torch.is_tensor(weights):
            weights = [weights[..., s] for s in self.weight_slices()]
        for ins, w in zip(self.instructions, weights):
            mi1, mi2, mi3 = self.irreps_in1[ins.i_in1], self.irreps_in2[ins.i_in2], self.irreps_out[ins.i_out]
            f1 = x1[..., sl1[ins.i_in1]].reshape(batch_shape + (mi1.mul, mi1.ir.dim))
            f2 = x2[..., sl2[ins.i_in2]].reshape(batch_shape + (mi2.mul, mi2.ir.dim))
            C = self._coupling(mi1.ir.l, mi2.ir.l, mi3.ir.l, x1)
            w = w.reshape(w.shape[:-1] + ins.weight_shape)
            t = torch.einsum("...ui,...vik->...uvk", f1, torch.einsum("...vj,ijk->...vik", f2, C))
            if ins.mode == "uvw":
                blk = torch.einsum("...uvk,...uvw->...wk", t, w)
            else:
                blk = torch.einsum("...uvk,...uv->...uk", t, w)
            blk = ins.path_weight * blk
            i3 = ins.i_out
            out_blocks[i3] = blk if out_blocks[i3] is None else out_blocks[i3] + blk

        flat = [
            x1.new_zeros(batch_shape + (mi3.dim,)) if blk is None else blk.reshape(batch_shape + (mi3.dim,))
            for mi3, blk in zip(self.irreps_out, out_blocks)
        ]
        return torch.cat(flat, dim=-1)


def fully_connected_tp(irreps_in1, irreps_in2, irreps_out) -> WeightedTensorProduct:
    """e3nn's FullyConnectedTensorProduct (external, unshared weights)."""
    return WeightedTensorProduct(irreps_in1, irreps_in2, irreps_out)


def depthwise_tp(irreps_in1, irreps_in2, irreps_out) -> Tuple[WeightedTensorProduct, Irreps]:
    """The depthwise ("uvu") product of the separable conv. Returns (tp,
    irreps_out_dtp): the dtp output irreps are every allowed (ir1 x ir2 ->
    ir3) product with ir3 in irreps_out or a scalar, in path order."""
    irreps_in1, irreps_in2, irreps_out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
    out_blocks, instructions = [], []
    for i1, mi1 in enumerate(irreps_in1):
        for i2, mi2 in enumerate(irreps_in2):
            for ir3 in mi1.ir * mi2.ir:
                if ir3 in irreps_out or (ir3.l == 0 and ir3.p == 1):
                    instructions.append((i1, i2, len(out_blocks), "uvu"))
                    out_blocks.append((mi1.mul, ir3))
    irreps_out_dtp = Irreps(out_blocks)
    return WeightedTensorProduct(irreps_in1, irreps_in2, irreps_out_dtp, instructions), irreps_out_dtp


def scale_irreps(x: torch.Tensor, scales: torch.Tensor, irreps) -> torch.Tensor:
    """Multiply the i-th irrep copy of x by scales[..., i] (scales
    [..., irreps.num_irreps]). The repeat counts are Python ints, so nothing
    waits on the device."""
    parts, ix = [], 0
    for mi in Irreps(irreps):
        s = scales[..., ix : ix + mi.mul]
        parts.append(s.repeat_interleave(mi.ir.dim, dim=-1) if mi.ir.dim > 1 else s)
        ix += mi.mul
    return x * torch.cat(parts, dim=-1).to(x.dtype)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def scale_irreps_transposed(xT: torch.Tensor, scales: torch.Tensor, irreps) -> torch.Tensor:
    """`scale_irreps` on JAX's transposed slot-padded layout
    (`pack_features_transposed`): xT [..., Sp + 3 Vp, N] for irreps `Sx0e
    (+ Vx1e)`, S and V padded to multiples of 16, the three vector
    components in planes; scales [..., S + V]."""
    irreps = Irreps(irreps)
    sv = irreps.sv_shape()
    if sv is None:
        raise ValueError(f"want Sx0e (+ Vx1e), got {irreps}")
    S, V = sv
    Sp, Vp = _pad16(S), _pad16(V)
    parts = [scales[..., :S], scales.new_zeros(scales.shape[:-1] + (Sp - S,))]
    if V:
        zv = scales.new_zeros(scales.shape[:-1] + (Vp - V,))
        parts += [scales[..., S:], zv] * 3
    rows = torch.cat(parts, dim=-1)
    return xT * rows[..., :, None].to(xT.dtype)
