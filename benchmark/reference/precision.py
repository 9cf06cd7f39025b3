"""The reference's arithmetic: float32 with TF32 off, or, for the controls, a
lower precision emulated at the inputs of every product.

`Precision.q` is applied to both operands of each matrix product and
tensor-product contraction of the reference. In float32 it is the identity.
The controls round the operands to the nearest precision below the
configuration's and keep the float32 accumulation the card's tensor cores
keep: "tf32" (10 mantissa bits, round to nearest even), the step below a
float32 configuration with TF32 off, and "fp8" (e4m3 with one scale per
tensor, its largest magnitude mapped to 448), the step below a bfloat16
configuration.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Precision", "F32", "round_tf32", "round_fp8", "reference_matmul_policy"]

_FP8_MAX = 448.0


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits (round to nearest, ties to even)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    odd = (bits >> 13) & 1
    up = (low > 0x1000) | ((low == 0x1000) & (odd == 1))
    return torch.where(up, keep + 0x2000, keep).view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 through float8 e4m3 with one scale for the tensor."""
    t = t.to(torch.float32)
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / _FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "f32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """t rounded to this precision. The rounding passes the gradient
        through unchanged, so a control that trains gets the gradients of
        the rounded products (the products of the backward take the rounded
        operands of the forward, as the tensor cores' would)."""
        if self.name == "f32":
            return t
        if self.name == "tf32":
            rounded = round_tf32(t.detach())
        elif self.name == "fp8":
            rounded = round_fp8(t.detach())
        else:
            raise ValueError(f"precision {self.name!r}")
        return t + (rounded - t).detach() if t.requires_grad else rounded


F32 = Precision("f32")


def reference_matmul_policy() -> None:
    """float32 products in float32 on the card: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
