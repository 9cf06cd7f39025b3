"""K5: one whole separable ConvBlock straight from the positions, for any
number of atoms (wrapper + plain twin).

Replaces `packed_fused_block_v2` of `jamun_tpu/ops/pallas/packed_conv.py`
(pallas_call at line 2819, body `_block_body`) and its per-forward inputs
`packed_geometry_inputs` (`packed_conv.py:2858`), which the JAX model takes
for every dense call above 128 atoms. The CUDA kernel is
`csrc/fused_block_tiled.cu`: the pair geometry (adjacency, spherical
harmonics, radial basis) is rebuilt inside the kernel from the positions, for
dense pairs and bonds alike, so no tensor with two atom axes ever exists in
device memory. Its bf16 build runs the radial MLP and the epilogue on the
tensor cores for 16 destination atoms per CTA (`csrc/tiled_pairs_mma.cuh`),
listing the pairs in passes over the sources where one list would not fit;
`layout` mirrors its shared-memory reckoning and `occupancy` asks the
library how the card launches it.

Inputs: block input x [G, N, S + 3V] (packed irreps, compute dtype), the
`TiledGeometry` of `tiled_geometry_inputs` (scaled positions, masks, bonds,
cutoff) and the block's `BlockWeights` (`ops/cuda/conv_block`, the same
packing as K2's). Output: f32 [G, N, Sc + 3Vg] in gate.irreps_out layout.
Forward only: the positions get no gradient (a position that wants one
raises, as `packed_geometry_inputs` refuses it), and a call that
differentiates the block above 128 atoms takes the model's plain path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.conv_block import (
    MAX_WIDTH,
    N_RADIAL,
    BlockWeights,
    _aggregate_plain,
    _epilogue_plain,
)
from jamun_tpu_torch.ops.cuda.edge_features import edge_features_plain

__all__ = [
    "TiledGeometry", "tiled_geometry_inputs", "fused_block_tiled",
    "fused_block_tiled_plain", "KERNEL", "MAX_ATOMS", "MAX_GRAPHS", "MAX_SHARED_BYTES",
    "pair_layout", "layout", "occupancy",
]

MAX_ATOMS = (1 << 19) - 1  # the pair list's index field (`conv_block::MAX_INDEX`)
MAX_GRAPHS = 65535  # one graph per step of the grid's second axis
MAX_SHARED_BYTES = 232448  # shared memory one block may use on sm_90
_PLAIN_PAIRS = 1 << 19  # dense pairs the plain version holds at a time

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 19 + [_F] + [_I] * 7 + [_P]
KERNEL = CudaKernel(
    "fused_block_tiled",
    {"fused_block_tiled_f32": _ARGS, "fused_block_tiled_bf16": _ARGS,
     "fused_block_tiled_smem": [_I] * 7, "fused_block_tiled_occupancy": [_I] * 7 + [_P]},
)
_ENTRY = {torch.float32: "fused_block_tiled_f32", torch.bfloat16: "fused_block_tiled_bf16"}
_TD, _TDM, _PT = 8, 16, 32  # dst atoms per CTA (FMA build, bf16 build), pairs per tile
_OCCUPANCY = ("threads", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm", "atoms_per_cta",
              "sources_per_pass", "staged")


# The kernels' shared-memory reckoning, mirrored from csrc/fused_block_tiled.cu
# (the FMA build: conv_block's scratch and the geometry words) and
# csrc/tiled_pairs_mma.cuh (`tiled::layout`, the bf16 builds of this kernel
# and of the dense messages, csrc/dense_conv.cu); `occupancy` reads the
# library's own.
def pair_layout(N: int, B: int, S: int, V: int, Sc: int = 0, Vg: int = 0) -> dict:
    """The bf16 CTA's launch shape (`tiled::layout`): 16 dst atoms; what
    lives through the CTA (accumulators, degree, counts), then one region
    for the pair loop (positions, a tile's pair data, the operand tiles, the
    source rows, a list of 16 J + B entries for J sources per pass) that the
    epilogue's tiles share after it (none when Sc + Vg == 0, the dense
    messages). J is N where that list fits 227 KB, else the largest multiple
    of 32 that fits (at least 32: a shape that does not fit then reckons more
    bytes than a block may use); the epilogue stages its B operands where
    `conv_block.stage_fits` says."""
    W, F, nt = 2 * S + 3 * V, S + 3 * V, k2.threads_for(2 * S + 3 * V)
    a = k2._align16
    region = a(_TDM * 3 * nt * 4) + a(_TDM * 4) + a(_TDM * 4) + 16
    lst = region + a(N * 16) + a(_PT * 16) + k2.pair_tiles_bytes(W) + a(_PT * F * 2)
    entries = int((MAX_SHARED_BYTES - lst) / 16) * 4 - B  # truncated as C++ divides
    if entries >= _TDM * N:
        J = N
    else:
        J = entries // _TDM // 32 * 32 if entries >= _TDM * 32 else 32
    pair_end = lst + a((_TDM * J + B) * 4)
    total = [pair_end, pair_end]
    if Sc + Vg > 0:
        for stage in (0, 1):
            epi = region + k2.epilogue_tiles_bytes(S, V, Sc + Vg, Vg, Sc, Vg, _TDM, bool(stage))
            total[stage] = max(pair_end, epi)
    staged = Sc + Vg > 0 and k2.stage_fits(total[1], total[0])
    return dict(threads=nt, smem_bytes=total[staged], atoms_per_cta=_TDM, sources_per_pass=J,
                staged=bool(staged))


def layout(N: int, B: int, S: int, V: int, Sc: int, Vg: int, cdt=torch.bfloat16) -> dict:
    """How K5 is launched at these sizes: threads and bytes of shared memory
    per CTA, dst atoms per CTA, sources per pass of the pair list, whether
    the epilogue stages its B operands. The f32 build keeps the FMA CTA of 8
    atoms with its whole list (8 N + B entries) and the positions."""
    if cdt == torch.bfloat16:
        return pair_layout(N, B, S, V, Sc, Vg)
    nt = k2.threads_for(2 * S + 3 * V)
    smem = k2.scratch_bytes(N, B, nt, Sc, Vg, _TD) + 4 * (4 * N + _PT)
    return dict(threads=nt, smem_bytes=smem, atoms_per_cta=_TD, sources_per_pass=N, staged=False)


def occupancy(N: int, B: int, S: int, V: int, Sc: int, Vg: int, cdt=torch.bfloat16) -> dict:
    """`layout` as the library reckons it, with what the current card makes
    of the build: registers and local (spill) bytes per thread, CTAs
    resident per SM."""
    out = (ctypes.c_int * len(_OCCUPANCY))()
    err = KERNEL.fn("fused_block_tiled_occupancy")(
        int(cdt == torch.bfloat16), N, B, S, V, Sc, Vg, ctypes.addressof(out)
    )
    if err != 0:
        raise RuntimeError(f"fused_block_tiled.fused_block_tiled_occupancy failed with CUDA error {err}")
    return {k: (bool(v) if k == "staged" else v) for k, v in zip(_OCCUPANCY, out)}


class TiledGeometry(NamedTuple):
    """What every ConvBlock of one forward reads besides its input: the
    counterpart of `packed_geometry_inputs`' (posm, bf, ebsT, ebd). The
    kernel takes the positions, masks and bond lists as they are: the
    position rows and bond one-hots of the TPU kernel exist for Mosaic's
    layout and do not carry over, and its bond features [G, EFR, B] are
    rebuilt in the kernel like the dense pairs'
    (`edge_features.bond_features_plain` gives them for the tests)."""

    pos: torch.Tensor  # [G, N, 3] f32, the scaled positions
    node_mask: torch.Tensor  # [G, N] bool
    bond_src: torch.Tensor  # [G, B] int64
    bond_dst: torch.Tensor  # [G, B] int64
    bond_mask: torch.Tensor  # [G, B] bool
    cutoff: float
    n_radial: int


def _refuse_position_gradient(pos: torch.Tensor) -> None:
    if pos.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused_block_tiled: no gradient with respect to the positions (the kernel "
            "rebuilds the edge geometry and drops its dependence); detach pos or run the "
            "plain path "
            "(ROADMAP.md queue A, 'Position gradients through the kernels')"
        )


def tiled_geometry_inputs(
    pos, node_mask, bond_src, bond_dst, bond_mask, cutoff: float, n_radial: int = N_RADIAL
) -> TiledGeometry:
    """The per-forward inputs of K5, made once and shared by every block.
    A position that requires a gradient raises, on both devices."""
    _refuse_position_gradient(pos)
    return TiledGeometry(
        pos.to(torch.float32).contiguous(), node_mask, bond_src, bond_dst, bond_mask,
        float(cutoff), int(n_radial),
    )


def fused_block_tiled_plain(
    x, geo: TiledGeometry, w: BlockWeights, return_degree: bool = False
):
    """The plain PyTorch version of the kernel: the same function with the
    same rounding points, composed from K1's and K2's plain versions (edge
    features of every pair in the compute dtype, then the aggregation and the
    epilogue), so K5, K2 and both twins round alike. It does build
    [G, N, N, *] tensors, `_PLAIN_PAIRS` dense pairs' worth of graphs at a time."""
    G, N, _ = x.shape
    step = max(1, _PLAIN_PAIRS // max(N * N, 1))
    outs, degs = [], []
    for g0 in range(0, G, step):
        sl = slice(g0, g0 + step)
        ef, bf = edge_features_plain(
            geo.pos[sl], geo.node_mask[sl], geo.bond_src[sl], geo.bond_dst[sl],
            geo.bond_mask[sl], geo.cutoff, geo.n_radial, x.dtype,
        )
        norm, deg = _aggregate_plain(x[sl], ef, bf, geo.bond_src[sl], geo.bond_dst[sl], w)
        outs.append(_epilogue_plain(x[sl], norm, w))
        degs.append(deg)
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return (out, torch.cat(degs)) if return_degree else out


def fused_block_tiled(x, geo: TiledGeometry, w: BlockWeights, return_degree: bool = False):
    """One ConvBlock from positions -> f32 [G, N, Sc + 3Vg]. CPU tensors take
    the plain version; CUDA tensors launch the kernel. With
    `return_degree=True` also the combined degree [G, N] f32 (the visited
    pairs and bonds per destination atom).

    Any N below 2^19 that fits a CTA's shared memory goes, N <= 128 and N not
    divisible by 8 included; the shared memory grows with N and B (f32: the
    pair list of 8 N + B entries; bf16: 16 bytes of position per atom beside
    a pass list of 16 J + B entries, `layout`), the kernel's library reckons
    it (`fused_block_tiled_smem`) and what a block cannot hold raises. The
    TPU kernel's bounds (`N % 8 == 0`, a dst block that divides N, `S >= 32`,
    `V == 0 or V >= 16`) come from Mosaic's tiling and are not copied."""
    _refuse_position_gradient(geo.pos)
    if x.device.type == "cpu":
        return fused_block_tiled_plain(x, geo, w, return_degree)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_tiled: unsupported device {x.device}")
    cdt = x.dtype
    if cdt not in _ENTRY:
        raise TypeError(f"fused_block_tiled: compute dtype {cdt} not supported")
    G, N, _ = x.shape
    B = geo.bond_src.shape[1]
    S, V, Sc, Vg = w.S, w.V, w.Sc, w.Vg
    W = 2 * S + 3 * V
    smem = KERNEL.fn("fused_block_tiled_smem")(int(cdt == torch.bfloat16), N, B, S, V, Sc, Vg)
    if (
        W > MAX_WIDTH or geo.n_radial != N_RADIAL or N > MAX_ATOMS or B > MAX_ATOMS
        or G > MAX_GRAPHS or smem > MAX_SHARED_BYTES
    ):
        raise NotImplementedError(
            f"fused_block_tiled: radial width {W} (max {MAX_WIDTH}), {geo.n_radial} radial "
            f"functions (want {N_RADIAL}), N={N}, B={B} (max {MAX_ATOMS}), G={G} (max "
            f"{MAX_GRAPHS}), {smem} bytes of shared memory per CTA (max {MAX_SHARED_BYTES}); "
            "see ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
        )
    f32, i64 = torch.float32, torch.int64
    checks = [
        ("x", x, cdt, (G, N, S + 3 * V)),
        ("pos", geo.pos, f32, (G, N, 3)),
        ("node_mask", geo.node_mask, torch.bool, (G, N)),
        ("bond_src", geo.bond_src, i64, (G, B)),
        ("bond_dst", geo.bond_dst, i64, (G, B)),
        ("bond_mask", geo.bond_mask, torch.bool, (G, B)),
        ("w1", w.w1, cdt, (N_RADIAL, 64)),
        ("b1d", w.b1d, f32, (64,)),
        ("b1b", w.b1b, f32, (64,)),
        ("w2", w.w2, cdt, (64, W)),
        ("b2", w.b2, f32, (W,)),
        ("pl0", w.pl0, cdt, (S + V, Sc + Vg)),
        ("pl1", w.pl1, cdt, (S + 2 * V, Vg)),
        ("lin20", w.lin20, cdt, (Sc, Sc)),
        ("lin21", w.lin21, cdt, (Vg, Vg)),
        ("sk0", w.sk0, cdt, (S, Sc)),
        ("sk1", w.sk1, cdt, (V, Vg)),
    ]
    for name, t, dt, shape in checks:
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_block_tiled: {name} must be {dt} {shape} contiguous on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty((G, N, Sc + 3 * Vg), dtype=f32, device=x.device)
    deg = torch.empty((G, N), dtype=f32, device=x.device) if return_degree else None
    KERNEL.launch(
        _ENTRY[cdt],
        x.data_ptr(), geo.pos.data_ptr(), geo.node_mask.data_ptr(), geo.bond_src.data_ptr(),
        geo.bond_dst.data_ptr(), geo.bond_mask.data_ptr(),
        w.w1.data_ptr(), w.b1d.data_ptr(), w.b1b.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
        w.pl0.data_ptr(), w.pl1.data_ptr(), w.lin20.data_ptr(), w.lin21.data_ptr(),
        w.sk0.data_ptr(), w.sk1.data_ptr(), out.data_ptr(),
        deg.data_ptr() if return_degree else None,
        geo.cutoff, G, N, B, S, V, Sc, Vg,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return (out, deg) if return_degree else out
