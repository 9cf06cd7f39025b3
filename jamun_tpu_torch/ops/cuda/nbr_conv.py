"""K6: the sparse capped-neighbour messages of one conv layer (wrapper +
plain twin).

Replaces `nbr_uvu_conv` of `jamun_tpu/ops/pallas/nbr_conv.py` (pallas_call
at line 371), which the JAX model runs in every ConvBlock of a forward
without a gradient on the sparse path. The CUDA kernel is
`csrc/nbr_conv.cu`: its f32 build runs FP32 FMAs for 16 destination atoms
per CTA, its bf16 build runs both radial layers on the tensor cores for 8
atoms per CTA (`csrc/conv_block_mma.cuh`); `layout` mirrors their
shared-memory reckoning and `occupancy` asks the library how the card
launches them.

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

from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.conv_block import MAX_WIDTH
from jamun_tpu_torch.ops.fast_uvu import uvu_messages
from jamun_tpu_torch.ops.neighbors import gather_neighbors

__all__ = [
    "nbr_uvu_conv", "nbr_uvu_conv_plain", "KERNEL", "ATTR_WIDTHS", "MAX_SLOTS", "MAX_ATOMS_BF16",
    "layout", "occupancy",
]

ATTR_WIDTHS = (32, 64)  # A: the radial half, or the whole edge attributes
RADIAL_HIDDEN = 64
MAX_SLOTS = 256  # K the kernel takes (`nbr_conv.cu`'s MAX_SLOTS)
# N the bf16 build takes: a tile's pair data packs dst slot << 16 | source
# atom into one word (`mma::pair_info`)
MAX_ATOMS_BF16 = (1 << 16) - 1
_LIMITS = "ROADMAP.md queue A, 'Sparse messages from 65536 atoms on'"
_TD = {torch.float32: 16, torch.bfloat16: 8}  # dst atoms per CTA (TDN, TDM)
_PT = 32  # slots per tile

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 11 + [_I] * 6 + [_P]
KERNEL = CudaKernel("nbr_conv", {
    "nbr_conv_f32": _ARGS, "nbr_conv_bf16": _ARGS, "nbr_conv_smem": [_I] * 5,
    "nbr_conv_occupancy": [_I] * 5 + [_P],
})
_ENTRY = {torch.float32: "nbr_conv_f32", torch.bfloat16: "nbr_conv_bf16"}
_OCCUPANCY = ("threads", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm", "atoms_per_cta")


def layout(A: int, K: int, S: int, V: int, cdt=torch.bfloat16) -> dict:
    """How K6 is launched at these sizes (the mirror of `nbr_conv_smem`):
    threads, bytes of shared memory per CTA and dst atoms per CTA. bf16
    (`mma_layout`): the accumulators, degree and list length of 8 atoms,
    then a tile's pair data, the operand tiles (layer 1 A wide) and the
    list of 8 K slots with their sources. f32 (`nbr_words`): the FMA CTA's
    f32 scratch and its list for 16 atoms."""
    nt, W = k2.threads_for(2 * S + 3 * V), 2 * S + 3 * V
    td = _TD[cdt]
    if cdt == torch.bfloat16:
        a16 = k2._align16
        smem = (a16(td * 3 * nt * 4) + a16(td * 4) + 16 + a16(_PT * 16)
                + k2.pair_tiles_bytes(W, A) + 2 * a16(td * K * 4))
    else:
        floats = A * 64 + 64 * _PT + _PT * A + _PT * 3 + td + td * 3 * nt
        smem = 4 * (floats + 2 * _PT + td * K + 1)
    return dict(threads=nt, smem_bytes=smem, atoms_per_cta=td)


def occupancy(A: int, K: int, S: int, V: int, cdt=torch.bfloat16) -> dict:
    """`layout` as the library reckons it, with what the current card makes
    of the build: registers and local (spill) bytes per thread, CTAs
    resident per SM."""
    out = (ctypes.c_int * len(_OCCUPANCY))()
    err = KERNEL.fn("nbr_conv_occupancy")(int(cdt == torch.bfloat16), A, K, S, V, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"nbr_conv.nbr_conv_occupancy failed with CUDA error {err}")
    return dict(zip(_OCCUPANCY, out))


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
    384, K above 256, in bf16 N from 65536 atoms on) raise
    NotImplementedError on the card."""
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
            f"K={K} (max {MAX_SLOTS}); see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
        )
    if cdt == torch.bfloat16 and N > MAX_ATOMS_BF16:
        raise NotImplementedError(
            f"nbr_uvu_conv: N={N} atoms in bf16 (max {MAX_ATOMS_BF16}: a tile packs the source "
            f"atom into 16 bits); see {_LIMITS}"
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
