"""The experimental product: the unweighted full tensor product followed by
a linear with external (per-element) weights (counterpart of
`jamun_tpu/ops/experimental_tp.py`, e3nn's `FullTensorProductv2` and an
externally weighted `o3.Linear`). Plain PyTorch einsums, as JAX's runs XLA
einsums: no TPU kernel reaches it.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple, Union

import torch

from jamun_tpu_torch.ops.cg import real_wigner_3j
from jamun_tpu_torch.ops.cuda.conv_block import rounded_divisor
from jamun_tpu_torch.ops.irreps import Irreps

__all__ = ["full_tensor_product", "ExperimentalTensorProduct", "external_linear"]

@functools.lru_cache(maxsize=None)
def _coupling(l1: int, l2: int, l3: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The CG tensor scaled by sqrt(2 l3 + 1), made once per device: a host
    tensor copied at every call would make the host wait for the device."""
    cg = real_wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
    return torch.as_tensor(cg, dtype=dtype, device=device)


def full_tensor_product_irreps(irreps1, irreps2) -> Irreps:
    """The output irreps of `full_tensor_product`: for every (i1, i2) pair
    of blocks, mul1 * mul2 copies of each allowed irrep."""
    irreps1, irreps2 = Irreps(irreps1), Irreps(irreps2)
    return Irreps([
        (mi1.mul * mi2.mul, ir3) for mi1 in irreps1 for mi2 in irreps2 for ir3 in mi1.ir * mi2.ir
    ])


def full_tensor_product(
    x1: torch.Tensor, x2: torch.Tensor, irreps1, irreps2
) -> Tuple[torch.Tensor, Irreps]:
    """Unweighted full product of x1 [..., irreps1.dim] and x2 [...,
    irreps2.dim]: every (i1, i2) pair of blocks gives mul1 * mul2 copies of
    each allowed output irrep. Returns (out [..., out.dim], out irreps)."""
    irreps1, irreps2 = Irreps(irreps1), Irreps(irreps2)
    sl1, sl2 = irreps1.slices(), irreps2.slices()
    batch = x1.shape[:-1]
    blocks = []
    for i1, mi1 in enumerate(irreps1):
        f1 = x1[..., sl1[i1]].reshape(batch + (mi1.mul, mi1.ir.dim))
        for i2, mi2 in enumerate(irreps2):
            f2 = x2[..., sl2[i2]].reshape(batch + (mi2.mul, mi2.ir.dim))
            for ir3 in mi1.ir * mi2.ir:
                C = _coupling(mi1.ir.l, mi2.ir.l, ir3.l, x1.dtype, x1.device)
                # x2 with C first, as `WeightedTensorProduct` contracts
                blk = torch.einsum("...ui,...vik->...uvk", f1, torch.einsum("...vj,ijk->...vik", f2, C))
                blocks.append(blk.reshape(batch + (mi1.mul * mi2.mul * ir3.dim,)))
    return torch.cat(blocks, dim=-1), full_tensor_product_irreps(irreps1, irreps2)


class _ExternalLinear:
    """e3nn's `o3.Linear` with external flat weights: each output block sums
    the input blocks of its irrep through a [mul_in, mul_out] slice of the
    weights, divided by sqrt of the fan-in multiplicity."""

    def __init__(self, irreps_in, irreps_out):
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        self.paths: List[Tuple[int, int, slice, Tuple[int, int]]] = []
        offset = 0
        for io, mo in enumerate(self.irreps_out):
            for ii, mi in enumerate(self.irreps_in):
                if mi.ir != mo.ir:
                    continue
                n = mi.mul * mo.mul
                self.paths.append((ii, io, slice(offset, offset + n), (mi.mul, mo.mul)))
                offset += n
        self.weight_numel = offset
        self._fan = [sum(mi.mul for mi in self.irreps_in if mi.ir == mo.ir) for mo in self.irreps_out]

    def weight_slices(self) -> List[slice]:
        """Each path's slice of the `weight_numel` weights, in path order."""
        return [wsl for _, _, wsl, _ in self.paths]

    def __call__(
        self, x: torch.Tensor, weights: Union[torch.Tensor, Sequence[torch.Tensor]]
    ) -> torch.Tensor:
        """x [..., irreps_in.dim]; weights [..., weight_numel], or split at
        `weight_slices` (one tensor per path)."""
        sl_in = self.irreps_in.slices()
        batch = x.shape[:-1]
        if torch.is_tensor(weights):
            weights = [weights[..., s] for s in self.weight_slices()]
        out = [None] * len(self.irreps_out)
        for (ii, io, _, (m_in, m_out)), w in zip(self.paths, weights):
            mi = self.irreps_in[ii]
            f = x[..., sl_in[ii]].reshape(batch + (m_in, mi.ir.dim))
            w = w.reshape(w.shape[:-1] + (m_in, m_out))
            # the divisor rounded to the compute dtype first, as JAX's weak
            # typing rounds `blk / math.sqrt(fan)` (a bf16 divisor in bf16)
            blk = torch.einsum("...ui,...uw->...wi", f, w)
            blk = blk / rounded_divisor(math.sqrt(max(self._fan[io], 1)), blk.dtype, blk.device)
            out[io] = blk if out[io] is None else out[io] + blk
        flat = [
            x.new_zeros(batch + (mo.dim,)) if blk is None else blk.reshape(batch + (mo.dim,))
            for mo, blk in zip(self.irreps_out, out)
        ]
        return torch.cat(flat, dim=-1)


def external_linear(irreps_in, irreps_out) -> _ExternalLinear:
    return _ExternalLinear(Irreps(irreps_in), Irreps(irreps_out))


class ExperimentalTensorProduct:
    """(x1, x2, weights) -> external_linear(full_tensor_product(x1, x2),
    weights); `weight_numel` weights per element, or one tensor per path of
    the linear (`weight_slices`)."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self._irreps_ftp = full_tensor_product_irreps(self.irreps_in1, self.irreps_in2)
        self._lin = _ExternalLinear(self._irreps_ftp, self.irreps_out)
        self.weight_numel = self._lin.weight_numel

    def weight_slices(self) -> List[slice]:
        return self._lin.weight_slices()

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor, weights) -> torch.Tensor:
        ftp, _ = full_tensor_product(x1, x2, self.irreps_in1, self.irreps_in2)
        return self._lin(ftp, weights)
