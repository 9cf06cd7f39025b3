"""Irreducible-representation metadata for O(3)-equivariant features.

The port's own copy of `jamun_tpu/ops/irreps.py`. Features are flat tensors
of shape [..., irreps.dim]; each (mul, l) block is laid out mul-major:
block.reshape(..., mul, 2l+1). The l=1 components are in (y, z, x) order.
`unpack_irreps` / `pack_irreps` split and join such tensors by block;
`Irreps.rotation_matrix` is the block-diagonal Wigner D (numpy, host side).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from jamun_tpu_torch.ops.wigner import wigner_D_from_matrix

__all__ = ["Irrep", "MulIrrep", "Irreps", "unpack_irreps", "pack_irreps"]


@dataclasses.dataclass(frozen=True, order=True)
class Irrep:
    l: int
    p: int  # parity: +1 (even, "e") or -1 (odd, "o")

    def __post_init__(self):
        if self.l < 0 or self.p not in (1, -1):
            raise ValueError(f"invalid irrep l={self.l} p={self.p}")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __mul__(self, other: "Irrep") -> List["Irrep"]:
        """Selection rule for the tensor product of two irreps."""
        p = self.p * other.p
        return [Irrep(l, p) for l in range(abs(self.l - other.l), self.l + other.l + 1)]

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    @classmethod
    def parse(cls, s: Union[str, "Irrep"]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        m = re.fullmatch(r"(\d+)([eo])", s.strip())
        if not m:
            raise ValueError(f"cannot parse irrep {s!r}")
        return cls(int(m.group(1)), 1 if m.group(2) == "e" else -1)


class MulIrrep(Tuple[int, Irrep]):
    def __new__(cls, mul: int, ir: Irrep):
        return super().__new__(cls, (mul, ir))

    def __getnewargs__(self):  # copy and pickle (modules are deep-copied for the EMA)
        return (self.mul, self.ir)

    @property
    def mul(self) -> int:
        return self[0]

    @property
    def ir(self) -> Irrep:
        return self[1]

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self) -> str:
        return f"{self.mul}x{self.ir}"


class Irreps(tuple):
    """An ordered sequence of (multiplicity, irrep) blocks, e.g. "120x0e + 32x1e"."""

    def __new__(cls, irreps: Union[str, "Irreps", Sequence]) -> "Irreps":
        if isinstance(irreps, Irreps):
            return super().__new__(cls, irreps)
        out: List[MulIrrep] = []
        if isinstance(irreps, str):
            if irreps.strip():
                for term in irreps.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul_s, ir_s = term.split("x")
                        out.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                    else:
                        out.append(MulIrrep(1, Irrep.parse(term)))
        else:
            for item in irreps:
                if isinstance(item, MulIrrep):
                    out.append(item)
                elif isinstance(item, Irrep):
                    out.append(MulIrrep(1, item))
                else:
                    mul, ir = item
                    out.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return super().__new__(cls, out)

    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        """Total multiplicity (number of irrep copies)."""
        return sum(mi.mul for mi in self)

    @property
    def lmax(self) -> int:
        return max((mi.ir.l for mi in self), default=0)

    def slices(self) -> List[slice]:
        out, ix = [], 0
        for mi in self:
            out.append(slice(ix, ix + mi.dim))
            ix += mi.dim
        return out

    def __contains__(self, ir) -> bool:
        if isinstance(ir, (Irrep, str)):
            ir = Irrep.parse(ir)
            return any(mi.ir == ir for mi in self)
        return super().__contains__(ir)

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __repr__(self) -> str:
        return " + ".join(repr(mi) for mi in self) if len(self) else "(empty)"

    def simplify(self) -> "Irreps":
        """Merge consecutive blocks with the same irrep."""
        out: List[List] = []
        for mi in self:
            if out and out[-1][1] == mi.ir:
                out[-1][0] += mi.mul
            elif mi.mul > 0:
                out.append([mi.mul, mi.ir])
        return Irreps([MulIrrep(m, ir) for m, ir in out])

    def rotation_matrix(self, R: np.ndarray) -> np.ndarray:
        """Block-diagonal representation matrix D(R) [dim, dim] (numpy). R is
        a 3x3 rotation acting on (x, y, z); for an improper R (det < 0) the
        odd-parity blocks take the parity sign."""
        det = float(np.linalg.det(R))
        Rp = np.asarray(R) * np.sign(det)
        out = np.zeros((self.dim, self.dim))
        ix = 0
        for mi in self:
            D = wigner_D_from_matrix(mi.ir.l, Rp)
            if det < 0 and mi.ir.p == -1:
                D = -D
            for _ in range(mi.mul):
                d = D.shape[0]
                out[ix : ix + d, ix : ix + d] = D
                ix += d
        return out

    def sv_shape(self):
        """(S, V) when the irreps are `Sx0e` or `Sx0e + Vx1e` (the l <= 1
        shapes the separable conv and its kernels take), else None."""
        if len(self) == 1 and self[0].ir == Irrep(0, 1):
            return self[0].mul, 0
        if len(self) == 2 and self[0].ir == Irrep(0, 1) and self[1].ir == Irrep(1, 1):
            return self[0].mul, self[1].mul
        return None


def unpack_irreps(x, irreps: Irreps) -> Iterator[Tuple[int, Irrep, "object"]]:
    """Yield (mul, ir, field [..., mul, 2l+1]) per block of a tensor (or
    numpy array) x [..., irreps.dim]."""
    irreps = Irreps(irreps)
    assert x.shape[-1] == irreps.dim, f"{tuple(x.shape)} vs {irreps}"
    ix = 0
    for mi in irreps:
        field = x[..., ix : ix + mi.dim].reshape(tuple(x.shape[:-1]) + (mi.mul, mi.ir.dim))
        ix += mi.dim
        yield mi.mul, mi.ir, field


def pack_irreps(fields, irreps: Irreps):
    """The inverse of `unpack_irreps`: [..., mul, 2l+1] tensors back to one
    [..., dim] tensor."""
    flat = [f.reshape(tuple(f.shape[:-2]) + (mi.dim,)) for f, mi in zip(fields, Irreps(irreps))]
    return torch.cat(flat, dim=-1)
