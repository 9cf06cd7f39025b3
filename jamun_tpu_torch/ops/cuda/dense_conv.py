"""K8 and K9: the dense messages of one conv layer straight from the
positions (wrappers + plain twins).

K8 replaces `packed_uvu_conv_dense` of `jamun_tpu/ops/pallas/packed_conv.py`
(pallas_call at line 515), which JAX's `Conv` runs for a dense call under
`pallas_variant="packed"` that its fused layer does not take. K9 replaces
`fused_uvu_conv_dense` of `jamun_tpu/ops/pallas/fused_conv.py` (pallas_call
at line 317), which every hidden layer of `E3Conv(pallas_variant="plane")`
runs. Both compute one function; K9 takes V > 0 only, as
`supports_fused_conv` does. Both launch the kernel of `csrc/dense_conv.cu`
(so they agree bit for bit), each through its own entry and launch counter.
Its bf16 build runs both radial layers on the tensor cores for 16
destination atoms per CTA (`csrc/tiled_pairs_mma.cuh`, shared with K5's),
listing the pairs in passes over the sources where one list would not fit;
`layout` mirrors its shared-memory reckoning and `occupancy` asks the
library how the card launches it.

Arguments, as JAX's: positions pos [G, N, 3] (the scaled positions the
arch sees), node_mask [G, N] bool, source features x [G, N, S + 3V] in the
compute dtype, the radial MLP's Dense kernels w1 [64, 64] (bondedness rows
first), b1 [64], w2 [64, 2S + 3V], b2 [2S + 3V], the bondedness-0 embedding
bond0 [32] and the cutoff (a Python float). The bondedness-0 block of the
first layer folds into b1 in f32, as both TPU wrappers fold it. Returns the
messages of the pairs inside the cutoff summed per destination atom, f32
[G, N, 4S + 7V] in [Sx0e | Sx1e | Vx1e | Vx0e | Vx1e] order ([G, N, 4S] at
V = 0), and the degree [G, N] f32 (dense pairs only). No bonds, no mean, no
post-linear. Forward only: JAX has no VJP for either kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.conv_block import MAX_WIDTH, N_RADIAL, pair_sums_plain
from jamun_tpu_torch.ops.cuda.edge_features import pair_features_plain
from jamun_tpu_torch.ops.cuda.fused_block_tiled import (
    _OCCUPANCY,
    MAX_ATOMS,
    MAX_GRAPHS,
    MAX_SHARED_BYTES,
    pair_layout,
)

__all__ = [
    "packed_uvu_conv_dense", "packed_uvu_conv_dense_plain", "fused_uvu_conv_dense",
    "fused_uvu_conv_dense_plain", "dense_weights", "K8", "K9", "layout", "occupancy",
]

RADIAL_HIDDEN = 64
_PLAIN_PAIRS = 1 << 19  # dense pairs the plain version holds at a time
_LIMITS = "ROADMAP.md queue A, 'Dense messages beyond one CTA'"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 9 + [_F] + [_I] * 4 + [_P]


def _entries(prefix: str) -> dict:
    return {f"{prefix}_f32": _ARGS, f"{prefix}_bf16": _ARGS, "dense_conv_smem": [_I] * 4,
            "dense_conv_occupancy": [_I] * 4 + [_P]}


K8 = CudaKernel("packed_uvu_conv_dense", _entries("packed_uvu_conv_dense"), source="dense_conv")
K9 = CudaKernel("fused_uvu_conv_dense", _entries("fused_uvu_conv_dense"), source="dense_conv")
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def layout(N: int, S: int, V: int, cdt=torch.bfloat16) -> dict:
    """How K8 and K9 are launched at these sizes (the mirror of
    `dense_conv_smem`): threads and bytes of shared memory per CTA, dst atoms
    per CTA, sources per pass of the pair list. bf16: K5's pair loop without
    bonds or epilogue (`fused_block_tiled.pair_layout`); f32: the FMA CTA of
    8 atoms with its whole list (8 N entries) and the positions."""
    if cdt == torch.bfloat16:
        return pair_layout(N, 0, S, V)
    nt = k2.threads_for(2 * S + 3 * V)
    smem = k2.scratch_bytes(N, 0, nt, 0, 0, 8) + 4 * (4 * N + 32)
    return dict(threads=nt, smem_bytes=smem, atoms_per_cta=8, sources_per_pass=N, staged=False)


def occupancy(N: int, S: int, V: int, cdt=torch.bfloat16) -> dict:
    """`layout` as the library reckons it, with what the current card makes
    of the build: registers and local (spill) bytes per thread, CTAs
    resident per SM."""
    out = (ctypes.c_int * len(_OCCUPANCY))()
    err = K9.fn("dense_conv_occupancy")(int(cdt == torch.bfloat16), N, S, V, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dense_conv.dense_conv_occupancy failed with CUDA error {err}")
    return {k: (bool(v) if k == "staged" else v) for k, v in zip(_OCCUPANCY, out)}


def dense_weights(w1, b1, w2, b2, bond0, cdt):
    """The kernel's radial operands: the radial rows of w1 [32, 64] and w2 in
    cdt, b1 with the bondedness-0 block folded in and b2 in f32."""
    f32 = torch.float32
    nb = w1.shape[0] - N_RADIAL
    b1_eff = b1.to(f32) + bond0.to(f32) @ w1[:nb].to(f32)
    return (
        w1[nb:].to(cdt).contiguous(), b1_eff.contiguous(), w2.to(cdt).contiguous(),
        b2.to(f32).contiguous(),
    )


def _plain(pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S: int, V: int):
    """K8's and K9's plain PyTorch version: K1's pair features of every pair
    (`pair_features_plain`, in the compute dtype) and K2's dense-pair sums
    (`pair_sums_plain`), so the twins round where K2's and K5's do. It builds
    [G, N, N, *] tensors, `_PLAIN_PAIRS` pairs' worth of graphs at a time."""
    cdt = x.dtype
    w = dense_weights(w1, b1, w2, b2, bond0, cdt)
    cutoff = float(torch.tensor(float(cutoff), dtype=torch.float32))
    pos = pos.to(torch.float32)
    G, N, _ = x.shape
    step = max(1, _PLAIN_PAIRS // max(N * N, 1))
    outs, degs = [], []
    for g0 in range(0, G, step):
        sl = slice(g0, g0 + step)
        ef = pair_features_plain(pos[sl], node_mask[sl], cutoff, N_RADIAL, cdt)
        out, deg = pair_sums_plain(x[sl], ef, *w, S, V)
        outs.append(out)
        degs.append(deg)
    return torch.cat(outs), torch.cat(degs)


def _refuse_v0(name: str, V: int) -> None:
    if V == 0:
        raise ValueError(f"{name}: V = 0 (scalar-only input); `supports_fused_conv` needs V > 0")


def packed_uvu_conv_dense_plain(pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S: int, V: int):
    """K8's plain version (see `_plain`)."""
    return _plain(pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S, V)


def fused_uvu_conv_dense_plain(pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S: int, V: int):
    """K9's plain version: K8's function, V > 0 only."""
    _refuse_v0("fused_uvu_conv_dense", V)
    return _plain(pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S, V)


def _launch(kernel: CudaKernel, pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S, V):
    name = kernel.name
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    cdt = x.dtype
    if cdt not in _TYPES:
        raise TypeError(f"{name}: compute dtype {cdt} not supported")
    G, N, _ = x.shape
    W = 2 * S + 3 * V
    smem = kernel.fn("dense_conv_smem")(int(cdt == torch.bfloat16), N, S, V)
    if (
        w1.shape != (2 * N_RADIAL, RADIAL_HIDDEN) or W > MAX_WIDTH or N > MAX_ATOMS
        or G > MAX_GRAPHS or smem > MAX_SHARED_BYTES
    ):
        raise NotImplementedError(
            f"{name}: radial layer 1 {tuple(w1.shape)} (want (64, 64)), radial width {W} (max "
            f"{MAX_WIDTH}), N={N} (max {MAX_ATOMS}), G={G} (max {MAX_GRAPHS}), {smem} bytes of "
            f"shared memory per CTA (max {MAX_SHARED_BYTES}): {_LIMITS}"
        )
    w1r, b1e, w2c, b2f = dense_weights(w1, b1, w2, b2, bond0, cdt)
    f32 = torch.float32
    checks = [
        ("x", x, cdt, (G, N, S + 3 * V)),
        ("pos", pos, f32, (G, N, 3)),
        ("node_mask", node_mask, torch.bool, (G, N)),
        ("w2", w2c, cdt, (RADIAL_HIDDEN, W)),
        ("b2", b2f, f32, (W,)),
    ]
    for arg, t, dt, shape in checks:
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be {dt} {shape} contiguous on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty((G, N, 4 * S + 7 * V), dtype=f32, device=x.device)
    deg = torch.empty((G, N), dtype=f32, device=x.device)
    kernel.launch(
        f"{name}_{_TYPES[cdt]}",
        x.data_ptr(), pos.data_ptr(), node_mask.data_ptr(), w1r.data_ptr(), b1e.data_ptr(),
        w2c.data_ptr(), b2f.data_ptr(), out.data_ptr(), deg.data_ptr(),
        float(cutoff), G, N, S, V,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out, deg


def packed_uvu_conv_dense(
    pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S: int, V: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: (messages f32 [G, N, 4S + 7V], degree f32 [G, N]), V >= 0. CPU
    tensors take the plain version; CUDA tensors launch the kernel. A shape
    the kernel cannot take raises NotImplementedError on the card."""
    if x.device.type == "cpu":
        return packed_uvu_conv_dense_plain(pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S, V)
    return _launch(K8, pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S, V)


def fused_uvu_conv_dense(
    pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S: int, V: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: K8's function for V > 0 (V = 0 raises ValueError on both
    devices). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _refuse_v0("fused_uvu_conv_dense", V)
    if x.device.type == "cpu":
        return fused_uvu_conv_dense_plain(pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S, V)
    return _launch(K9, pos, node_mask, x, w1, b1, w2, b2, bond0, cutoff, S, V)
