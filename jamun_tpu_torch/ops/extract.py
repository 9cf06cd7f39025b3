"""Irreps slicing and scaling helpers (counterpart of
`jamun_tpu/ops/extract.py`, e3tools' `ExtractIrreps` and `ScaleIrreps`)."""

from __future__ import annotations

import torch
from torch import nn

from jamun_tpu_torch.ops.irreps import Irrep, Irreps
from jamun_tpu_torch.ops.tensor_product import scale_irreps

__all__ = ["extract_irreps", "ExtractIrreps", "ScaleIrreps"]


def _irrep_list(keep):
    return [Irrep.parse(k) for k in (keep if isinstance(keep, (list, tuple)) else [keep])]


def extract_irreps(x: torch.Tensor, irreps_in, keep) -> torch.Tensor:
    """The blocks of x [..., irreps_in.dim] whose irrep is in `keep`, in
    their order."""
    irreps_in, keep = Irreps(irreps_in), _irrep_list(keep)
    parts = [x[..., s] for s, mi in zip(irreps_in.slices(), irreps_in) if mi.ir in keep]
    return torch.cat(parts, dim=-1) if parts else x[..., :0]


class ExtractIrreps(nn.Module):
    def __init__(self, irreps_in, irreps_extract):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.keep = _irrep_list(irreps_extract)
        self.irreps_out = Irreps([mi for mi in self.irreps_in if mi.ir in self.keep])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return extract_irreps(x, self.irreps_in, self.keep)


class ScaleIrreps(nn.Module):
    """Per irrep copy scaling (the elementwise product with scalars)."""

    def __init__(self, irreps_in):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = self.irreps_in

    def forward(self, x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        return scale_irreps(x, scales, self.irreps_in)
