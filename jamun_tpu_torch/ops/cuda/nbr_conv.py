"""K6: the sparse capped-neighbour messages of one conv layer (wrapper +
plain twin).

Replaces `nbr_uvu_conv` of `jamun_tpu/ops/pallas/nbr_conv.py` (pallas_call
at line 371), which the JAX model runs in every ConvBlock of a forward
without a gradient on the sparse path. The CUDA kernel is
`csrc/nbr_conv.cu`.

Inputs: source features x [G, N, S + 3V] (packed irreps, compute dtype),
per slot the spherical harmonics sh [G, N, K, 4] and edge attributes
attr [G, N, K, A] (compute dtype; A = 64, or 32 for the radial half of
`nbr_edge_features` with the bondedness-0 block folded into b1), the list
idx [G, N, K] int64 and mask [G, N, K] f32, and the radial MLP
w1 [A, 64], w2 [64, 2S + 3V] (compute dtype), b1, b2 (f32). Outputs, as
`fast_uvu_messages_nbr(x, sh, radial_nn(attr), idx, mask)`: the summed
messages [G, N, 4S + 7V] f32 in [Sx0e | Sx1e | Vx1e | Vx0e | Vx1e] order and
the degree [G, N] f32 (the masked-in slots). Forward only, as in JAX.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.conv_block import MAX_WIDTH
from jamun_tpu_torch.ops.fast_uvu import uvu_messages
from jamun_tpu_torch.ops.neighbors import gather_neighbors

__all__ = ["nbr_uvu_conv", "nbr_uvu_conv_plain", "KERNEL", "ATTR_WIDTHS", "MAX_SLOTS"]

ATTR_WIDTHS = (32, 64)  # A: the radial half, or the whole edge attributes
RADIAL_HIDDEN = 64
MAX_SLOTS = 256  # K the kernel takes (`nbr_conv.cu`'s MAX_SLOTS)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 11 + [_I] * 6 + [_P]
KERNEL = CudaKernel("nbr_conv", {"nbr_conv_f32": _ARGS, "nbr_conv_bf16": _ARGS})
_ENTRY = {torch.float32: "nbr_conv_f32", torch.bfloat16: "nbr_conv_bf16"}


def nbr_uvu_conv_plain(x, sh, attr, idx, mask, w1, b1, w2, b2, S: int, V: int):
    """The plain PyTorch version of the kernel: the same function with the
    same rounding points (h and the radial weights in the compute dtype,
    f32 products and sums). Slots whose mask is 0 contribute nothing, and
    their index is not followed."""
    f32, cdt = torch.float32, x.dtype
    h = F.silu(attr.to(f32) @ w1.to(f32) + b1).to(cdt).to(f32)
    w = (h @ w2.to(f32) + b2).to(cdt).to(f32)
    m = mask.to(f32)
    xg = gather_neighbors(x.to(f32), torch.where(m > 0, idx, torch.zeros_like(idx)))
    msg = uvu_messages(xg, sh.to(f32), w, S, V)
    return (msg * m[..., None]).sum(2), (m > 0).sum(-1).to(f32)


def nbr_uvu_conv(
    x, sh, attr, idx, mask, w1, b1, w2, b2, S: int, V: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(messages [G, N, 4S + 7V] f32, degree [G, N] f32). CPU tensors take
    the plain version; CUDA tensors launch the kernel. Shapes outside the
    kernel (A not 32 or 64, a hidden width other than 64, 2S + 3V above
    384, K above 256) raise NotImplementedError on the card."""
    if x.device.type == "cpu":
        return nbr_uvu_conv_plain(x, sh, attr, idx, mask, w1, b1, w2, b2, S, V)
    if x.device.type != "cuda":
        raise ValueError(f"nbr_uvu_conv: unsupported device {x.device}")
    cdt = x.dtype
    if cdt not in _ENTRY:
        raise TypeError(f"nbr_uvu_conv: compute dtype {cdt} not supported")
    G, N, K = idx.shape
    A, W = attr.shape[-1], 2 * S + 3 * V
    if A not in ATTR_WIDTHS or w1.shape[-1] != RADIAL_HIDDEN or W > MAX_WIDTH or K > MAX_SLOTS:
        raise NotImplementedError(
            f"nbr_uvu_conv: {A} edge attributes (want one of {ATTR_WIDTHS}), radial hidden width "
            f"{w1.shape[-1]} (want {RADIAL_HIDDEN}), radial width {W} (max {MAX_WIDTH}), "
            f"K={K} (max {MAX_SLOTS})"
        )
    f32 = torch.float32
    checks = [
        ("x", x, cdt, (G, N, S + 3 * V)),
        ("sh", sh, cdt, (G, N, K, 4)),
        ("attr", attr, cdt, (G, N, K, A)),
        ("idx", idx, torch.int64, (G, N, K)),
        ("mask", mask, f32, (G, N, K)),
        ("w1", w1, cdt, (A, RADIAL_HIDDEN)),
        ("b1", b1, f32, (RADIAL_HIDDEN,)),
        ("w2", w2, cdt, (RADIAL_HIDDEN, W)),
        ("b2", b2, f32, (W,)),
    ]
    for name, t, dt, shape in checks:
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"nbr_uvu_conv: {name} must be {dt} {shape} contiguous on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty((G, N, 4 * S + 7 * V), dtype=f32, device=x.device)
    deg = torch.empty((G, N), dtype=f32, device=x.device)
    KERNEL.launch(
        _ENTRY[cdt],
        x.data_ptr(), sh.data_ptr(), attr.data_ptr(), idx.data_ptr(), mask.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), deg.data_ptr(),
        G, N, K, A, S, V,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out, deg
