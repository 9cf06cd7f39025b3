"""Weighted Clebsch-Gordan tensor products on packed irreps tensors
(counterpart of `jamun_tpu/ops/tensor_product.py:28-143`).

Each path (i1, i2) -> i3 computes

    t[..., u, v, k] = sum_{i,j} C[i,j,k] x1[..., u, i] x2[..., v, j]
    out[..., w, k] += path_weight * sum_{u,v} W[..., u, v, w] t[..., u, v, k]

The uvw paths run per output group, not per path: consecutive output blocks
of one irrep whose paths read the same input pairs make a group (at the
flagship width `120x0e + 32x0e`, from 0e x 0e and 1e x 1e, and `32x1e`, from
0e x 1e, 1e x 0e and 1e x 1e), and a group is one batched product

    out[p, w, k] = sum_U W[p, w, U] T[p, U, k],

U running over the (u, v) of the group's paths in path order, so the sum
over its paths happens inside the product. T takes one matmul of x2 with
every coupling (C scaled by sqrt(d3) and by the path weight, laid out per x1
block: x2 with C first, the order opt_einsum picks), one bmm per x1 block
with that block's features, and one `cat` a group of its paths' columns: the
same products as path by path, and no dense work added. A group's weights
are its paths' columns of the flat weights in [w, U] order, gathered by an
index made once per device (`weight_groups`), so that the radial MLP's last
layer writes them in the product's layout (`Conv._path_weights`). uvu
instructions, and any path into a block that a uvu path also writes, keep
the per-path einsums. `PRODUCT_CALLS` counts the calls of each kind.

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
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from jamun_tpu_torch.ops.cg import real_wigner_3j
from jamun_tpu_torch.ops.irreps import Irreps

__all__ = [
    "WeightedTensorProduct", "fully_connected_tp", "depthwise_tp", "scale_irreps",
    "scale_irreps_transposed", "PRODUCT_CALLS",
]

# cumulative host counts of `WeightedTensorProduct` calls that ran grouped
# uvw paths and per-path ones (a call with both counts in each)
PRODUCT_CALLS = {"grouped": 0, "per_path": 0}


@dataclasses.dataclass(frozen=True)
class Instruction:
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # "uvw" | "uvu"
    path_weight: float
    weight_offset: int
    weight_shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class _Group:
    """Consecutive uvw output blocks `outs` of one irrep (k = its dim) whose
    paths read the same input pairs: `parts` holds, per path in path order,
    (i1, the path's first column in the t of x1 block i1, mul2, k);
    `columns` the flat weights' index of W [w, U]."""

    outs: Tuple[int, ...]
    w: int
    U: int
    k: int
    parts: Tuple[Tuple[int, int, int, int], ...]
    columns: np.ndarray


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
        self._build_groups()
        # (l1, l2, l3, dtype, device) -> the scaled CG tensor of a path, and
        # (dtype, device) -> the groups' couplings, device -> their weight
        # index, made once per device: a host tensor copied at every call
        # would make the host wait
        self._cg = {}
        self._couplings = {}
        self._index = {}

    def _build_groups(self) -> None:
        """The uvw groups (`_groups`); the stacked couplings
        (`_couplings_np`, [irreps_in2.dim, *]) and, per x1 block they read,
        (i1, its first column there, M: the columns of its t [P, mul1, M]),
        in `_units`; the instructions left to the per-path loop (`_paths`)."""
        by_out: List[List[Instruction]] = [[] for _ in self.irreps_out]
        for ins in self.instructions:
            by_out[ins.i_out].append(ins)
        grouped = [bool(p) and all(ins.mode == "uvw" for ins in p) for p in by_out]
        self._paths = [ins for ins in self.instructions if not grouped[ins.i_out]]

        runs: List[List[int]] = []  # consecutive grouped blocks of one irrep and pairs
        for i3, paths in enumerate(by_out):
            if not grouped[i3]:
                continue
            prev = runs[-1][-1] if runs else None
            if (
                prev == i3 - 1 and self.irreps_out[prev].ir == self.irreps_out[i3].ir
                and [(p.i_in1, p.i_in2) for p in by_out[prev]] == [(p.i_in1, p.i_in2) for p in paths]
            ):
                runs[-1].append(i3)
            else:
                runs.append([i3])

        # the couplings of each x1 block: one column set per (i2, l3, path
        # weight), v-major within it, shared by every path that needs it
        keys: Dict[int, Dict[Tuple[int, int, float], int]] = {}
        for run in runs:
            for ins in by_out[run[0]]:
                cols = keys.setdefault(ins.i_in1, {})
                key = (ins.i_in2, self.irreps_out[run[0]].ir.l, ins.path_weight)
                if key not in cols:
                    cols[key] = sum(self.irreps_in2[i2].mul * (2 * l3 + 1) for i2, l3, _ in cols)
        starts2 = [s.start for s in self.irreps_in2.slices()]
        width = {i1: sum(self.irreps_in2[i2].mul * (2 * l3 + 1) for i2, l3, _ in cols)
                 for i1, cols in keys.items()}
        cbig = np.zeros((self.irreps_in2.dim, sum(self.irreps_in1[i1].ir.dim * m for i1, m in width.items())))
        self._units, col0 = [], 0
        for i1, cols in keys.items():
            l1, d1, M = self.irreps_in1[i1].ir.l, self.irreps_in1[i1].ir.dim, width[i1]
            self._units.append((i1, col0, M))
            for (i2, l3, pw), off in cols.items():
                mi2 = self.irreps_in2[i2]
                d2, d3 = mi2.ir.dim, 2 * l3 + 1
                C = real_wigner_3j(l1, mi2.ir.l, l3) * (math.sqrt(d3) * pw)  # [d1, d2, d3]
                for v in range(mi2.mul):
                    rows = starts2[i2] + v * d2 + np.arange(d2)
                    for i in range(d1):
                        c = col0 + i * M + off + v * d3
                        cbig[rows, c:c + d3] = C[i]
            col0 += d1 * M
        self._couplings_np = cbig

        self._groups: List[_Group] = []
        for run in runs:
            k = self.irreps_out[run[0]].ir.dim
            parts = tuple(
                (p.i_in1, keys[p.i_in1][(p.i_in2, self.irreps_out[run[0]].ir.l, p.path_weight)],
                 self.irreps_in2[p.i_in2].mul, k)
                for p in by_out[run[0]]
            )
            rows = []
            for i3 in run:  # W[w, U] = flat[offset + (u mul2 + v) mul3 + w]
                mul3 = self.irreps_out[i3].mul
                rows.append(np.concatenate([
                    p.weight_offset + np.arange(p.weight_shape[0] * p.weight_shape[1])[None, :] * mul3
                    + np.arange(mul3)[:, None]
                    for p in by_out[i3]
                ], axis=1))
            columns = np.concatenate(rows, axis=0)
            self._groups.append(_Group(tuple(run), columns.shape[0], columns.shape[1], k, parts, columns))

    def _coupling(self, l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
        key = (l1, l2, l3, like.dtype, like.device)
        if key not in self._cg:
            cg = real_wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
            self._cg[key] = torch.as_tensor(cg, dtype=like.dtype, device=like.device)
        return self._cg[key]

    def weight_groups(self, device: torch.device) -> List[Union[torch.Tensor, slice]]:
        """The columns of the flat `weight_numel` weights that each entry of
        a weight list holds, in the call's order: each uvw group's W [w, U]
        (an index on `device`, made once), then each per-path instruction's
        slice, in path order."""
        device = torch.device(device)
        if device not in self._index:
            self._index[device] = [
                torch.as_tensor(g.columns.reshape(-1), device=device) for g in self._groups
            ] + [
                slice(ins.weight_offset, ins.weight_offset + int(np.prod(ins.weight_shape)))
                for ins in self._paths
            ]
        return self._index[device]

    def __call__(
        self, x1: torch.Tensor, x2: torch.Tensor, weights: Union[torch.Tensor, Sequence[torch.Tensor]]
    ) -> torch.Tensor:
        """x1 [..., irreps_in1.dim], x2 [..., irreps_in2.dim], weights
        [..., weight_numel] (per element) or [weight_numel] (shared), or a
        list of the columns at `weight_groups` (one tensor each, per element
        or shared); computed in x1's dtype."""
        batch_shape = x1.shape[:-1]
        if x1.dim() != 2:
            x1, x2 = x1.reshape(-1, x1.shape[-1]), x2.reshape(-1, x2.shape[-1])
        if torch.is_tensor(weights):
            weights = [
                weights[..., c] if isinstance(c, slice) else weights.index_select(-1, c)
                for c in self.weight_groups(weights.device)
            ]
        blocks: List[Optional[torch.Tensor]] = [None] * len(self.irreps_out)
        if self._groups:
            PRODUCT_CALLS["grouped"] += 1
            self._grouped(x1, x2, weights[: len(self._groups)], blocks)
        if self._paths:
            PRODUCT_CALLS["per_path"] += 1
            self._per_path(x1, x2, weights[len(self._groups):], blocks)

        flat, i3 = [], 0
        while i3 < len(self.irreps_out):
            blk = blocks[i3]
            flat.append(x1.new_zeros((x1.shape[0], self.irreps_out[i3].dim)) if blk is None else blk)
            i3 += 1
            while i3 < len(self.irreps_out) and blocks[i3] is blk and blk is not None:
                i3 += 1  # a group's later blocks: its output holds them
        out = flat[0] if len(flat) == 1 else torch.cat(flat, dim=-1)
        return out if len(batch_shape) == 1 else out.reshape(batch_shape + (self.irreps_out.dim,))

    def _grouped(self, x1, x2, weights, blocks) -> None:
        """Each group's output [P, w k] into `blocks` at each of its blocks."""
        key = (x1.dtype, x1.device)
        if key not in self._couplings:
            self._couplings[key] = torch.as_tensor(self._couplings_np, dtype=x1.dtype, device=x1.device)
        P = x1.shape[0]
        y = x2 @ self._couplings[key]  # [P, sum of d1 M]
        sl1 = self.irreps_in1.slices()
        t = {}
        for i1, col0, M in self._units:  # t[p, u, (v, k) of each column set]
            mi1 = self.irreps_in1[i1]
            d1 = mi1.ir.dim
            t[i1] = torch.bmm(x1[:, sl1[i1]].reshape(P, mi1.mul, d1), y[:, col0:col0 + d1 * M].reshape(P, d1, M))
        for g, w in zip(self._groups, weights):
            parts = [
                t[i1][:, :, off:off + v * k] if v == 1 else t[i1][:, :, off:off + v * k].reshape(P, -1, k)
                for i1, off, v, k in g.parts
            ]
            T = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)  # [P, U, k]
            if w.dim() == 1:  # shared
                out = torch.matmul(w.reshape(g.w, g.U), T)
            else:
                out = torch.bmm(w.reshape(P, g.w, g.U), T)
            out = out.reshape(P, g.w * g.k)
            for i3 in g.outs:
                blocks[i3] = out

    def _per_path(self, x1, x2, weights, blocks) -> None:
        """Three einsums a path, summed into `blocks` (x1, x2 [P, *])."""
        batch_shape = x1.shape[:-1]
        sl1, sl2 = self.irreps_in1.slices(), self.irreps_in2.slices()
        for ins, w in zip(self._paths, weights):
            mi1, mi2, mi3 = self.irreps_in1[ins.i_in1], self.irreps_in2[ins.i_in2], self.irreps_out[ins.i_out]
            f1 = x1[..., sl1[ins.i_in1]].reshape(batch_shape + (mi1.mul, mi1.ir.dim))
            f2 = x2[..., sl2[ins.i_in2]].reshape(batch_shape + (mi2.mul, mi2.ir.dim))
            C = self._coupling(mi1.ir.l, mi2.ir.l, mi3.ir.l, x1)
            w = w.reshape((() if w.dim() == 1 else batch_shape) + ins.weight_shape)
            t = torch.einsum("...ui,...vik->...uvk", f1, torch.einsum("...vj,ijk->...vik", f2, C))
            if ins.mode == "uvw":
                blk = torch.einsum("...uvk,...uvw->...wk", t, w)
            else:
                blk = torch.einsum("...uvk,...uv->...uk", t, w)
            blk = (ins.path_weight * blk).reshape(batch_shape + (mi3.dim,))
            i3 = ins.i_out
            blocks[i3] = blk if blocks[i3] is None else blocks[i3] + blk


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
