"""K3: the whole E3Conv arch forward of a walk step in one launch (wrapper +
plain twin).

Replaces `packed_e3conv_stack` of `jamun_tpu/ops/pallas/e3_stack.py`
(pallas_call at line 367). The CUDA kernel is `csrc/e3_stack.cu`: edge
geometry -> projector ConvBlock -> L x [noise scale -> ConvBlock ->
noise-conditioned skip blend] -> EquivariantMLP head, one thread-block
cluster per graph, N <= 64. Forward only: the walk never differentiates the
score network, and training takes the per-layer kernels.

Inputs: the scaled positions and bonds of `edge_features`, the noise-scaled
atom embedding nf0 [G, N, S_emb] (f32; rounded to the compute dtype inside),
the projector's `BlockWeights`, the hidden blocks' `BlockWeights` with every
tensor stacked on a leading layer axis, the pre-layer noise scales and the
skip blend weights [L, S + V] (f32, one per irrep copy) and the head's
`HeadWeights`. Output: f32 [G, N, irreps_out.dim] in the packed layout of
`out_blocks`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.conv_block import (
    MAX_SMEM,
    MAX_WIDTH,
    N_RADIAL,
    BlockWeights,
    _align16,
    _comp_rows,
    _ld,
    epilogue_tiles_bytes,
    fused_conv_block_plain,
    pair_tiles_bytes,
    rounded_divisor,
    scratch_bytes,
    stage_fits,
    threads_for,
)
from jamun_tpu_torch.ops.cuda.edge_features import edge_features_plain

__all__ = [
    "HeadWeights", "pack_head_weights", "stack_block_weights", "stack_supported",
    "e3conv_stack", "e3conv_stack_plain", "launch_shape", "stack_smem_bytes", "stack_shape",
    "KERNEL", "MAX_ATOMS", "MAX_GRAPHS",
]

MAX_ATOMS = 64  # one cluster per graph: at most 4 CTAs of 16 atoms, or 8 of 8
MAX_GRAPHS = 65535  # one cluster per graph along the grid's second axis

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 5 + [_F] + [_P] * 10 + [_I] * 10 + [_P]
KERNEL = CudaKernel(
    "e3_stack", {"e3_stack_f32": _ARGS, "e3_stack_bf16": _ARGS, "e3_stack_shape": [_I] * 7 + [_P]}
)
_ENTRY = {torch.float32: "e3_stack_f32", torch.bfloat16: "e3_stack_bf16"}


class HeadWeights(NamedTuple):
    """The EquivariantMLP head's kernels in the compute dtype, [in, out], each
    cast and then divided by sqrt(fan-in) rounded to the compute dtype."""

    b00: torch.Tensor  # [S, S]   block linear, scalars -> scalars
    b01: torch.Tensor  # [S, V]   block linear, scalars -> gates
    b12: torch.Tensor  # [V, V]   block linear, vectors -> gated vectors
    f0: torch.Tensor  # [S, C0o]  final linear, the l = 0 output blocks side by side
    f1: torch.Tensor  # [V, V1o]  final linear, the l = 1 output blocks side by side
    out_blocks: Tuple[Tuple[int, int], ...]  # ((mul, l), ...) of irreps_out


def stack_supported(N: int, S: int, V: int, S_emb: int, out_blocks_final) -> bool:
    """The shapes the kernel takes: N <= 64 (one cluster of at most 8 CTAs of
    8 atoms), the per-layer kernel's width limit (one thread per radial
    channel) for the hidden blocks and the projector, V >= 1 (the kernel
    indexes the vector block; the TPU kernel's V >= 16 is a Mosaic tiling
    constraint and does not carry over), and every output block l <= 1 with
    even parity (`out_blocks_final`: (mul, l, p) triples)."""
    return (
        N <= MAX_ATOMS
        and max(2 * S + 3 * V, 2 * S_emb) <= MAX_WIDTH
        and S >= 1 and V >= 1 and S_emb >= 1
        and all(l <= 1 and p == 1 for _, l, p in out_blocks_final)
    )


_PT = 32  # pairs per tile
MAX_CLUSTER = 8  # CTAs per cluster (the portable limit)
MAX_ATOMS_PER_CTA = 16


def stack_smem_bytes(N: int, B: int, S: int, V: int, S_emb: int, td: int,
                     compute_dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of shared memory of one CTA owning td atoms, mirrored from
    csrc/e3_stack.cu (`stack_words` for f32, `stack_layout` for bf16)."""
    Wh, Wp = 2 * S + 3 * V, 2 * S_emb
    nt = threads_for(max(Wh, Wp))
    F = S + 3 * V
    Fmax = max(F, S_emb)
    if compute_dtype != torch.bfloat16:
        return scratch_bytes(N, B, nt, S, V, td) + 4 * (3 * N + _PT + N * Fmax + 3 * td * F)
    persistent = (_align16(td * 3 * nt * 4) + _align16(td * 4) + _align16(_PT * 16)
                  + _align16(_PT * 4) + _align16((td * N + B + 1) * 4) + _align16(N * 3 * 4)
                  + _align16(N * Fmax * 2) + _align16(td * F * 4) + _align16(2 * td * F * 2))
    head = (2 * _align16(16 * _ld(S) * 2) + 2 * _align16(_comp_rows(td) * _ld(V) * 2)
            + _align16(td * V * 4))
    unstaged, staged = (
        persistent + max(
            pair_tiles_bytes(max(Wh, Wp)), epilogue_tiles_bytes(S, V, S + V, V, S, V, td, stage),
            epilogue_tiles_bytes(S_emb, 0, S + V, V, S, V, td, stage), head,
        )
        for stage in (False, True)
    )
    return staged if stage_fits(staged, unstaged) else unstaged


def stack_shape(N: int, B: int, S: int, V: int, S_emb: int, atoms_per_cta: int = 0,
                compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch shape the kernel picks (csrc/e3_stack.cu `shape_for`): the
    smallest power-of-two cluster whose CTAs own at most 16 atoms each and
    fit their shared memory, or `atoms_per_cta` atoms per CTA when given."""
    nt = threads_for(max(2 * S + 3 * V, 2 * S_emb))

    def with_td(td):
        return dict(ctas_per_cluster=-(-N // td), atoms_per_cta=td, threads=nt,
                    smem_bytes=stack_smem_bytes(N, B, S, V, S_emb, td, compute_dtype))

    if atoms_per_cta > 0 or N == 0:
        return with_td(atoms_per_cta if atoms_per_cta > 0 else 1)
    ncta = 1
    while True:
        sh = with_td(-(-N // ncta))
        if (sh["atoms_per_cta"] <= MAX_ATOMS_PER_CTA and sh["smem_bytes"] <= MAX_SMEM) or ncta >= MAX_CLUSTER:
            return sh
        ncta *= 2


def launch_shape(N: int, B: int, S: int, V: int, S_emb: int, atoms_per_cta: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """How the kernel is launched at these sizes on the current card: CTAs
    per cluster (one cluster per graph), atoms per CTA, threads, bytes of
    shared memory per CTA, how many clusters the card holds at once, the
    registers and local (spill) bytes per thread and the CTAs resident per
    SM. `atoms_per_cta` as in `e3conv_stack`."""
    out = (ctypes.c_int * 8)()
    err = KERNEL.fn("e3_stack_shape")(
        int(compute_dtype == torch.bfloat16), N, B, S, V, S_emb, atoms_per_cta,
        ctypes.addressof(out),
    )
    if err != 0:
        raise RuntimeError(f"e3_stack.e3_stack_shape failed with CUDA error {err}")
    keys = ("ctas_per_cluster", "atoms_per_cta", "threads", "smem_bytes", "clusters_at_once",
            "registers", "spill_bytes", "ctas_per_sm")
    return dict(zip(keys, out))


def pack_head_weights(mlp, irreps_out, S: int, V: int, cdt) -> HeadWeights:
    """`HeadWeights` of an `EquivariantMLP(hidden -> hidden -> irreps_out)`
    (counterpart of `_pack_head_weights`, without its transposes and pads)."""
    blk = mlp.EquivariantMLPBlock_0.IrrepsLinear_0
    fin = mlp.IrrepsLinear_0

    def scaled(w, fan):
        return (w.to(cdt) / rounded_divisor(math.sqrt(max(fan, 1)), cdt, w.device)).contiguous()

    def side_by_side(l, i_in, fan):
        cols = [fin.weight(i_in, j) for j, mi in enumerate(irreps_out) if mi.ir.l == l]
        if not cols:
            return blk.weight(0, 0).new_zeros((fan, 0), dtype=cdt)
        return scaled(torch.cat(cols, dim=1), fan)

    return HeadWeights(
        b00=scaled(blk.weight(0, 0), S),
        b01=scaled(blk.weight(0, 1), S),
        b12=scaled(blk.weight(1, 2), V),
        f0=side_by_side(0, 0, S),
        f1=side_by_side(1, 1, V),
        out_blocks=tuple((mi.mul, mi.ir.l) for mi in irreps_out),
    )


def stack_block_weights(blocks) -> BlockWeights:
    """The hidden blocks' `BlockWeights` with every tensor stacked [L, ...]."""
    first = blocks[0]
    stacked = [torch.stack(ts) for ts in zip(*(b.tensors() for b in blocks))]
    return BlockWeights(*stacked, first.S, first.V, first.Sc, first.Vg)


def _layer(layers_w: BlockWeights, l: int) -> BlockWeights:
    return BlockWeights(*(t[l] for t in layers_w.tensors()), *layers_w[11:])


def _per_component(coef: torch.Tensor, S: int) -> torch.Tensor:
    """[S + V] per irrep copy -> [S + 3V] per channel (vector block [V][3])."""
    return torch.cat([coef[:S], coef[S:].repeat_interleave(3)])


def _reassemble(out: torch.Tensor, out_blocks) -> torch.Tensor:
    """[.., C0o + 3 V1o] (scalars, then vectors [V1o][3]) -> irreps_out order."""
    ls = [l for _, l in out_blocks]
    if ls == sorted(ls):
        return out  # the scalar blocks already come first
    parts, off0, off1 = [], 0, sum(mul for mul, l in out_blocks if l == 0)
    for mul, l in out_blocks:
        if l == 0:
            parts.append(out[..., off0 : off0 + mul])
            off0 += mul
        else:
            parts.append(out[..., off1 : off1 + 3 * mul])
            off1 += 3 * mul
    return torch.cat(parts, dim=-1)


def stack_head_plain(x: torch.Tensor, head_w: HeadWeights, cdt) -> torch.Tensor:
    """The head with the stack kernel's rounding points (`_stack_kernel`):
    inputs cast to the compute dtype, f32 sums out of every product, sigmoid
    and leaky-ReLU in f32, the activated scalars and the gated vectors cast
    to the compute dtype once. x [G, N, S + 3V] f32 -> f32 [G, N, C0o + 3 V1o]."""
    f32 = torch.float32
    G, N = x.shape[:2]
    S, V = head_w.b00.shape[0], head_w.b12.shape[0]
    xs = x[..., :S].to(cdt).to(f32)
    xv = x[..., S:].reshape(G, N, V, 3).to(cdt).to(f32)
    s_act = F.leaky_relu(xs @ head_w.b00.to(f32), 0.01).to(cdt).to(f32)
    gates = torch.sigmoid(xs @ head_w.b01.to(f32))
    v_pre = torch.einsum("gnvc,vq->gnqc", xv, head_w.b12.to(f32))
    gated = (v_pre * gates[..., None]).to(cdt).to(f32)
    out0 = s_act @ head_w.f0.to(f32)
    out1 = torch.einsum("gnvc,vq->gnqc", gated, head_w.f1.to(f32))
    return torch.cat([out0, out1.reshape(G, N, -1)], dim=-1)


def e3conv_stack_plain(
    pos, node_mask, bond_src, bond_dst, bond_mask, cutoff: float, nf0,
    proj_w: BlockWeights, layers_w: BlockWeights, scales, skipw, head_w: HeadWeights,
    n_radial: int = N_RADIAL, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function with the
    same rounding points, composed from the plain versions of the edge
    features and of the ConvBlock and the plain stack head."""
    cdt = compute_dtype
    S = proj_w.Sc
    ef, bf = edge_features_plain(
        pos, node_mask, bond_src, bond_dst, bond_mask, cutoff, n_radial, cdt
    )
    x = fused_conv_block_plain(nf0.to(cdt), ef, bf, bond_src, bond_dst, proj_w)
    for l in range(scales.shape[0]):
        xs = (x * _per_component(scales[l], S)).to(cdt)
        y = fused_conv_block_plain(xs, ef, bf, bond_src, bond_dst, _layer(layers_w, l))
        w = _per_component(skipw[l], S)
        x = x * w + y * (1.0 - w)
    return _reassemble(stack_head_plain(x, head_w, cdt), head_w.out_blocks)


def e3conv_stack(
    pos, node_mask, bond_src, bond_dst, bond_mask, cutoff: float, nf0,
    proj_w: BlockWeights, layers_w: BlockWeights, scales, skipw, head_w: HeadWeights,
    n_radial: int = N_RADIAL, compute_dtype: torch.dtype = torch.float32,
    atoms_per_cta: int = 0,
) -> torch.Tensor:
    """The whole arch forward -> f32 [G, N, irreps_out.dim]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (one launch).
    `atoms_per_cta` sets how a graph's atoms are split over the CTAs of its
    cluster (0: the kernel's own choice, which fills the card best; the
    result does not depend on it beyond the order of f32 sums)."""
    cutoff = float(cutoff)
    args = (pos, node_mask, bond_src, bond_dst, bond_mask, cutoff, nf0, proj_w, layers_w,
            scales, skipw, head_w, n_radial, compute_dtype)
    if pos.device.type == "cpu":
        return e3conv_stack_plain(*args)
    if pos.device.type != "cuda":
        raise ValueError(f"e3conv_stack: unsupported device {pos.device}")
    cdt = compute_dtype
    if cdt not in _ENTRY:
        raise TypeError(f"e3conv_stack: compute dtype {cdt} not supported")
    G, N, _ = pos.shape
    B = bond_src.shape[1]
    L = scales.shape[0]
    S_emb, S, V = proj_w.S, proj_w.Sc, proj_w.Vg
    out_blocks3 = tuple((mul, l, 1) for mul, l in head_w.out_blocks)
    hidden = (layers_w.S, layers_w.V, layers_w.Sc, layers_w.Vg)
    if (
        not stack_supported(N, S, V, S_emb, out_blocks3) or n_radial != N_RADIAL
        or proj_w.V != 0 or hidden != (S, V, S, V) or L < 1
    ):
        raise NotImplementedError(
            f"e3conv_stack: N={N} (max {MAX_ATOMS}), hidden {hidden}, projector "
            f"({S_emb}, {proj_w.V}) -> ({S}, {V}), {n_radial} radial functions, {L} layers, "
            f"output blocks {head_w.out_blocks} are outside the kernel; see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
        )
    if G > MAX_GRAPHS:
        raise NotImplementedError(
            f"e3conv_stack: {G} graphs in one launch (max {MAX_GRAPHS}); split the batch "
            "(the unfused jump does with jump_chunk_size); see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
        )
    C0o = sum(mul for mul, l in head_w.out_blocks if l == 0)
    V1o = sum(mul for mul, l in head_w.out_blocks if l == 1)
    f32, i64 = torch.float32, torch.int64

    def block_checks(prefix, w, lead, s_in, v_in):
        return [
            (f"{prefix}.w1", w.w1, cdt, lead + (N_RADIAL, 64)),
            (f"{prefix}.b1d", w.b1d, f32, lead + (64,)),
            (f"{prefix}.b1b", w.b1b, f32, lead + (64,)),
            (f"{prefix}.w2", w.w2, cdt, lead + (64, 2 * s_in + 3 * v_in)),
            (f"{prefix}.b2", w.b2, f32, lead + (2 * s_in + 3 * v_in,)),
            (f"{prefix}.pl0", w.pl0, cdt, lead + (s_in + v_in, S + V)),
            (f"{prefix}.pl1", w.pl1, cdt, lead + (s_in + 2 * v_in, V)),
            (f"{prefix}.lin20", w.lin20, cdt, lead + (S, S)),
            (f"{prefix}.lin21", w.lin21, cdt, lead + (V, V)),
            (f"{prefix}.sk0", w.sk0, cdt, lead + (s_in, S)),
            (f"{prefix}.sk1", w.sk1, cdt, lead + (v_in, V)),
        ]

    checks = [
        ("pos", pos, f32, (G, N, 3)),
        ("node_mask", node_mask, torch.bool, (G, N)),
        ("bond_src", bond_src, i64, (G, B)),
        ("bond_dst", bond_dst, i64, (G, B)),
        ("bond_mask", bond_mask, torch.bool, (G, B)),
        ("nf0", nf0, f32, (G, N, S_emb)),
        ("scales", scales, f32, (L, S + V)),
        ("skipw", skipw, f32, (L, S + V)),
        ("head.b00", head_w.b00, cdt, (S, S)),
        ("head.b01", head_w.b01, cdt, (S, V)),
        ("head.b12", head_w.b12, cdt, (V, V)),
        ("head.f0", head_w.f0, cdt, (S, C0o)),
        ("head.f1", head_w.f1, cdt, (V, V1o)),
        *block_checks("proj", proj_w, (), S_emb, 0),
        *block_checks("layers", layers_w, (L,), S, V),
    ]
    for name, t, dt, shape in checks:
        if t.device != pos.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"e3conv_stack: {name} must be {dt} {shape} contiguous on {pos.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty((G, N, C0o + 3 * V1o), dtype=f32, device=pos.device)
    weights = (ctypes.c_void_p * 22)(
        *(t.data_ptr() for t in proj_w.tensors() + layers_w.tensors())
    )
    KERNEL.launch(
        _ENTRY[cdt],
        pos.data_ptr(), node_mask.data_ptr(), bond_src.data_ptr(), bond_dst.data_ptr(),
        bond_mask.data_ptr(), cutoff, nf0.data_ptr(), ctypes.addressof(weights),
        scales.data_ptr(), skipw.data_ptr(), head_w.b00.data_ptr(), head_w.b01.data_ptr(),
        head_w.b12.data_ptr(), head_w.f0.data_ptr(), head_w.f1.data_ptr(), out.data_ptr(),
        G, N, B, S, V, S_emb, L, C0o, V1o, atoms_per_cta,
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    return _reassemble(out, head_w.out_blocks)
