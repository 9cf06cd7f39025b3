"""K4: the backward of one whole separable ConvBlock (wrapper + plain twin).

Replaces `packed_conv_block_bwd` of `jamun_tpu/ops/pallas/packed_conv.py`
(pallas_call at line 2220, kernel body `_block_bwd_kernel`). The CUDA kernel
is `csrc/conv_block_bwd.cu`; `ops/cuda/conv_block.conv_block_trainable`
calls it as the backward of K2. Its f32 build runs FP32 FMAs throughout;
its bf16 build runs the node pass's eight products (16 atoms per CTA), the
row products (split over the rows) and the pair pass's five products (16
source atoms per CTA) on the tensor cores. `pair_layout` and `node_layout`
mirror the shared-memory reckoning of the pair pass and the node pass;
`occupancy` asks the library how the card launches the pair pass.

Inputs: the cotangent g of K2's output [G, N, Sc + 3Vg] f32, K2's inputs
(x, edge features, bond indices, the packed weights of `pack_block_weights`)
and K2's residuals (normalised aggregates [G, N, 3, 2S + 3V] f32, degree
[G, N] f32). Output: a dict of f32 gradients, "dx" [G, N, S + 3V] and one
per packed weight under its `BlockWeights` name, in the packed layout (the
gradient with respect to the kernel's operand, before the 1/sqrt(fan-in)
scale and the cast).

Rounding points follow `_block_bwd_kernel` without its o2 fold, as K2's
forward does: g, d_scal, d_conv0, d_conv1, d_in0/d_in1, d_pre, each
un-aggregated cotangent (d_pre read at the pair's destination),
rnd(t2_cot), d_wall, d_h32 and each pair's source cotangent are rounded to
the compute dtype; every product and sum between them is f32.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.edge_features import EF_GEOM

__all__ = [
    "conv_block_bwd", "conv_block_bwd_plain", "KERNEL", "MAX_WIDTH", "GRAD_NAMES", "pair_layout",
    "node_layout", "occupancy",
]

N_RADIAL = 32
MAX_WIDTH = 384  # 2S + 3V: one thread per radial channel, at most 384 threads
MAX_SMEM = 232448  # bytes of shared memory one block may use on the H100
TS = {torch.float32: 8, torch.bfloat16: 16}  # source atoms per CTA of the pair pass
PART = (N_RADIAL + 2) * 64  # per-block partial of [dw1; db1d; db1b], then dw2, db2
_PT = 32  # pairs per tile of the bf16 pair pass
_AT, _RC = 32, 256  # the bf16 row products: output tile edge, rows per chunk
GRAD_NAMES = ("w1", "b1d", "b1b", "w2", "b2", "pl0", "pl1", "lin20", "lin21", "sk0", "sk1")
_INV_SQRT3 = 1.0 / math.sqrt(3.0)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 34 + [_I] * 7 + [_P]
KERNEL = CudaKernel("conv_block_bwd", {
    "conv_block_bwd_f32": _ARGS, "conv_block_bwd_bf16": _ARGS, "conv_block_bwd_smem": [_I] * 5,
    "conv_block_bwd_occupancy": [_I] * 5 + [_P],
})
_ENTRY = {torch.float32: "conv_block_bwd_f32", torch.bfloat16: "conv_block_bwd_bf16"}
_OCCUPANCY = ("threads", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm", "sources_per_cta")


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def _ld(k: int) -> int:
    return (k + 15) // 16 * 16 + 8


def pair_layout(N: int, B: int, S: int, V: int, cdt=torch.bfloat16) -> dict:
    """How K4's pair pass is launched at these sizes (the mirror of
    `conv_block_bwd_smem`): threads, bytes of shared memory per CTA and
    source atoms per CTA. bf16 (`pair_layout` of the source): the weights
    (w2 n-major), the tile's operand tiles of 32 pairs (radial features both
    ways, h both ways, h32, w, d_w_all both ways, d_h32), the CTA's 16 source
    rows and their dx sums, the dW1 sums, the tile's pair data and the list
    of 16 N + B entries. f32 (`pair_smem`): the FMA pass's f32 scratch for 8
    sources."""
    W, F = 2 * S + 3 * V, S + 3 * V
    nt = max(64, (W + 31) // 32 * 32)
    if cdt == torch.bfloat16:
        Wk = (W + 15) // 16 * 16
        LR, LH, LP, ldw = _ld(N_RADIAL), _ld(64), _ld(_PT), _ld(Wk)
        parts = [64 * LR * 2, Wk * 64 * 2, _PT * LR * 2, 48 * LP * 2, _PT * LH * 2, 64 * LP * 2,
                 _PT * 64 * 4, _PT * ldw * 2, _PT * ldw * 2, Wk * LP * 2, 64 * LP * 2, 16 * F * 2,
                 16 * F * 4, PART * 4, _PT * 6 * 4, 17 * 4, (16 * N + B) * 4]
        smem = sum(_a16(b) for b in parts)
    else:
        CS = 2 * S + 9 * V
        floats = (2 * 64 * 16 + N_RADIAL * 64 + W * 65 + 16 * N_RADIAL + 16 * W + 16 * CS
                  + 2 * 8 * F + PART + 16 * 3)
        smem = 4 * (floats + 3 * 16 + 8 * N + B + 1)
    return dict(threads=nt, smem_bytes=smem, sources_per_cta=TS[cdt])


def node_layout(S: int, V: int, Sc: int, Vg: int, cdt=torch.bfloat16) -> dict:
    """How K4's node pass is launched (the mirror of `node_layout` and
    `node_smem`): bytes of shared memory per CTA and atoms per CTA. bf16:
    the A tiles of 16 atoms (in0, in1 per component, g0, g1, d_conv0,
    d_conv1; [rows][ld(K)] bf16) and the f32 results (conv0, conv1,
    d_gated, d_scal). f32: 8 atoms' f32 scratch."""
    C0 = Sc + Vg
    if cdt == torch.bfloat16:
        parts = [16 * _ld(S + V) * 2, 48 * _ld(S + 2 * V) * 2, 16 * _ld(Sc) * 2, 48 * _ld(Vg) * 2,
                 16 * _ld(C0) * 2, 48 * _ld(Vg) * 2, 16 * C0 * 4, 48 * Vg * 4, 48 * Vg * 4, 16 * Sc * 4]
        return dict(smem_bytes=sum(_a16(b) for b in parts), atoms_per_cta=16)
    return dict(smem_bytes=8 * (2 * C0 + 9 * Vg + Sc) * 4, atoms_per_cta=8)


def occupancy(N: int, B: int, S: int, V: int, cdt=torch.bfloat16) -> dict:
    """`pair_layout` as the library reckons it, with what the current card
    makes of the pair pass: registers and local (spill) bytes per thread,
    CTAs resident per SM."""
    out = (ctypes.c_int * len(_OCCUPANCY))()
    err = KERNEL.fn("conv_block_bwd_occupancy")(int(cdt == torch.bfloat16), N, B, S, V,
                                                ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"conv_block_bwd.conv_block_bwd_occupancy failed with CUDA error {err}")
    return dict(zip(_OCCUPANCY, out))


def _row_product_partials(M: int, S: int, V: int, Sc: int, Vg: int) -> int:
    """Floats of the bf16 row products' chunk partials: per product [K, Q]
    over M * ncomp rows, one 32 x 32 tile per chunk of 256 rows."""
    jobs = [(S + V, Sc + Vg, 1), (S + 2 * V, Vg, 3), (Sc, Sc, 1), (Vg, Vg, 3), (S, Sc, 1), (V, Vg, 3)]
    tiles = lambda n: (n + _AT - 1) // _AT  # noqa: E731
    return sum(tiles(K) * tiles(Q) * ((M * c + _RC - 1) // _RC) * _AT * _AT
               for K, Q, c in jobs if K and Q)


def node_row_width(S: int, V: int, Sc: int, Vg: int) -> int:
    """Floats per atom of the node pass's rows (the operands of the weight
    gradients of the post-linear, second linear and skip)."""
    return (S + V) + (Sc + Vg) + 3 * (S + 2 * V) + 3 * Vg + 2 * Sc + 6 * Vg + S + 3 * V


def _pair_bwd(w, feat, b1, xsrc, d_dst, mask, cdt):
    """The per-pair backward over any leading shape: edge features feat
    [..., EC], source features xsrc [..., S + 3V] f32, the destination's
    d_pre d_dst [..., 3, W], the pair mask [...]. Returns the source
    cotangent [..., S + 3V] and this stream's (dw1, db1, dw2, db2)."""
    f32 = torch.float32
    rnd = lambda t: t.to(cdt).to(f32)  # noqa: E731
    S, V = w.S, w.V
    sh = feat[..., 0:3].to(f32)
    shy, shz, shx = sh.unbind(-1)
    r = feat[..., EF_GEOM:].to(f32)
    h32 = r @ w.w1.to(f32) + b1
    sig = torch.sigmoid(h32)
    h = rnd(h32 * sig)
    wall = rnd(h @ w.w2.to(f32) + w.b2)
    sj = xsrc[..., :S]
    d = d_dst
    d_m1 = d[..., 0, :S]
    d_w = [d_m1 * sj]
    t2c = d[..., 0, S : 2 * S] * shy[..., None] + d[..., 1, S : 2 * S] * shz[..., None]
    t2c = t2c + d[..., 2, S : 2 * S] * shx[..., None]
    d_w.append(t2c * sj)
    d_s = d_m1 * wall[..., :S] + rnd(t2c) * wall[..., S : 2 * S]
    parts = [rnd(d_s)]
    if V:
        v = xsrc[..., S:].reshape(xsrc.shape[:-1] + (V, 3))
        vy, vz, vx = v.unbind(-1)
        sy, sz, sx = shy[..., None], shz[..., None], shx[..., None]
        o3, o4, o5 = 2 * S, 2 * S + V, 2 * S + 2 * V
        d3 = [d[..., c, o3 : o3 + V] for c in range(3)]
        d4 = d[..., 0, o4 : o4 + V]
        d5 = [d[..., c, o5 : o5 + V] for c in range(3)]
        w3, w4, w5 = wall[..., o3 : o3 + V], wall[..., o4 : o4 + V], wall[..., o5 : o5 + V]
        dotv = vy * sy + vz * sz + vx * sx
        cy, cz, cx = vz * sx - vx * sz, vx * sy - vy * sx, vy * sz - vz * sy
        d_w += [
            d3[0] * vy + d3[1] * vz + d3[2] * vx,
            d4 * dotv * _INV_SQRT3,
            (d5[0] * cy + d5[1] * cz + d5[2] * cx) * _INV_SQRT2,
        ]
        d_vy = d3[0] * w3 + d4 * w4 * sy * _INV_SQRT3 + (d5[2] * sz - d5[1] * sx) * w5 * _INV_SQRT2
        d_vz = d3[1] * w3 + d4 * w4 * sz * _INV_SQRT3 + (d5[0] * sx - d5[2] * sy) * w5 * _INV_SQRT2
        d_vx = d3[2] * w3 + d4 * w4 * sx * _INV_SQRT3 + (d5[1] * sy - d5[0] * sz) * w5 * _INV_SQRT2
        parts.append(rnd(torch.stack([d_vy, d_vz, d_vx], -1)).flatten(-2))
    m = mask[..., None]
    d_src = torch.cat(parts, -1) * m
    d_wall = rnd(torch.cat(d_w, -1)) * m
    d_h = d_wall @ w.w2.to(f32).T
    d_h32 = rnd(d_h * (sig + h32 * sig * (1.0 - sig)))
    lead = d_wall.shape[:-1].numel()
    flat = lambda t: t.reshape(lead, t.shape[-1])  # noqa: E731
    dw1 = flat(r).T @ flat(d_h32)
    dw2 = flat(h).T @ flat(d_wall)
    return d_src, dw1, flat(d_h32).sum(0), dw2, flat(d_wall).sum(0)


def conv_block_bwd_plain(g, x, ef, bf, bond_src, bond_dst, w, agg, deg) -> dict:
    """The plain PyTorch version of K4: the same function with the same
    rounding points, written out (not autograd through the forward)."""
    f32, cdt = torch.float32, x.dtype
    rnd = lambda t: t.to(cdt).to(f32)  # noqa: E731
    S, V, Sc, Vg = w.S, w.V, w.Sc, w.Vg
    W = 2 * S + 3 * V
    G, N, _ = x.shape
    xf = x.to(f32)
    ein = torch.einsum

    # ---- per node: recompute the epilogue from the saved aggregates ----
    A = agg
    o5 = slice(2 * S + 2 * V, W)
    in0 = torch.cat([A[:, :, 0, :S], A[:, :, 0, 2 * S + V : 2 * S + 2 * V]], -1)
    in1 = torch.cat([A[..., S : 2 * S], A[..., 2 * S : 2 * S + V], A[..., o5]], -1)  # [G,N,3,S+2V]
    conv0 = in0 @ w.pl0.to(f32)
    conv1 = in1 @ w.pl1.to(f32)  # [G, N, 3, Vg]
    scal_pre = conv0[..., :Sc]
    scal = rnd(F.leaky_relu(scal_pre, 0.01))
    gates = torch.sigmoid(conv0[..., Sc:])[:, :, None]  # [G, N, 1, Vg]
    gated = rnd(conv1 * gates)

    g0 = rnd(g[..., :Sc])
    g1 = rnd(g[..., Sc:].reshape(G, N, Vg, 3).transpose(-1, -2))  # [G, N, 3, Vg]
    xs, xv = xf[..., :S], xf[..., S:].reshape(G, N, V, 3).transpose(-1, -2)  # [G,N,3,V]
    out = {
        "lin20": ein("gnk,gnq->kq", scal, g0),
        "lin21": ein("gnck,gncq->kq", gated, g1),
        "sk0": ein("gnk,gnq->kq", xs, g0),
        "sk1": ein("gnck,gncq->kq", xv, g1),
    }
    d_scal = rnd(g0 @ w.lin20.to(f32).T)
    d_gated = g1 @ w.lin21.to(f32).T
    d_x_s = g0 @ w.sk0.to(f32).T
    d_x_v = g1 @ w.sk1.to(f32).T  # [G, N, 3, V]

    d_conv0_s = rnd(d_scal * torch.where(scal_pre >= 0, 1.0, 0.01))
    d_conv1 = rnd(d_gated * gates)
    d_gates = (d_gated * conv1).sum(2)
    g_s = gates[:, :, 0]
    d_conv0 = torch.cat([d_conv0_s, rnd(d_gates * (g_s * (1.0 - g_s)))], -1)
    out["pl0"] = ein("gnk,gnq->kq", in0, d_conv0)
    out["pl1"] = ein("gnck,gncq->kq", in1, d_conv1)
    d_in0 = rnd(d_conv0 @ w.pl0.to(f32).T)  # [G, N, S + V]
    d_in1 = rnd(d_conv1 @ w.pl1.to(f32).T)  # [G, N, 3, S + 2V]

    dP = torch.zeros_like(A)
    dP[:, :, 0, :S] = d_in0[..., :S]
    dP[..., S : 2 * S] = d_in1[..., :S]
    if V:
        dP[..., 2 * S : 2 * S + V] = d_in1[..., S : S + V]
        dP[:, :, 0, 2 * S + V : 2 * S + 2 * V] = d_in0[..., S:]
        dP[..., o5] = d_in1[..., S + V :]
    d_pre = rnd(dP * (1.0 / torch.clamp(deg, min=1.0))[..., None, None])

    # ---- per pair: dense pairs [g, dst i, src j], then bonds ----
    ds_d, dw1_d, db1d, dw2_d, db2_d = _pair_bwd(
        w, ef, w.b1d, xf[:, None], d_pre[:, :, None], ef[..., 3].to(f32), cdt
    )
    gather = lambda t, idx: torch.gather(  # noqa: E731
        t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2)).expand(idx.shape + t.shape[2:])
    )
    ds_b, dw1_b, db1b, dw2_b, db2_b = _pair_bwd(
        w, bf, w.b1b, gather(xf, bond_src), gather(d_pre, bond_dst), bf[..., 3].to(f32), cdt
    )
    d_skip = torch.cat([d_x_s, d_x_v.transpose(-1, -2).reshape(G, N, 3 * V)], -1)
    dx = d_skip + ds_d.sum(1)
    dx = dx.scatter_add(1, bond_src[..., None].expand(-1, -1, dx.shape[-1]), ds_b)
    out.update(dx=dx, w1=dw1_d + dw1_b, b1d=db1d, b1b=db1b, w2=dw2_d + dw2_b, b2=db2_d + db2_b)
    return out


def conv_block_bwd(g, x, ef, bf, bond_src, bond_dst, w, agg, deg) -> dict:
    """K4 -> the dict of `conv_block_bwd_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return conv_block_bwd_plain(g, x, ef, bf, bond_src, bond_dst, w, agg, deg)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_bwd: unsupported device {x.device}")
    cdt = x.dtype
    if cdt not in _ENTRY:
        raise TypeError(f"conv_block_bwd: compute dtype {cdt} not supported")
    G, N, _ = x.shape
    B = bond_src.shape[1]
    S, V, Sc, Vg = w.S, w.V, w.Sc, w.Vg
    W = 2 * S + 3 * V
    ec = EF_GEOM + N_RADIAL
    if W > MAX_WIDTH or ef.shape[-1] != ec:
        raise NotImplementedError(
            f"conv_block_bwd: radial width {W} (max {MAX_WIDTH}) / "
            f"{ef.shape[-1] - EF_GEOM} radial functions (want {N_RADIAL}); see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
        )
    if cdt in TS and pair_layout(N, B, S, V, cdt)["smem_bytes"] > MAX_SMEM:
        raise NotImplementedError(
            f"conv_block_bwd: N={N}, B={B}: the pair pass's list of its sources' pairs does not "
            f"fit a block's shared memory (K2's regime, N <= 128, does); see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
        )
    f32 = torch.float32
    checks = [
        ("g", g, f32, (G, N, Sc + 3 * Vg)),
        ("x", x, cdt, (G, N, S + 3 * V)),
        ("ef", ef, cdt, (G, N, N, ec)),
        ("bf", bf, cdt, (G, B, ec)),
        ("bond_src", bond_src, torch.int64, (G, B)),
        ("bond_dst", bond_dst, torch.int64, (G, B)),
        ("agg", agg, f32, (G, N, 3, W)),
        ("deg", deg, f32, (G, N)),
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
                f"conv_block_bwd: {name} must be {dt} {shape} contiguous on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    dev = x.device
    empty = lambda *shape: torch.empty(shape, dtype=f32, device=dev)  # noqa: E731
    out = {
        "dx": empty(G, N, S + 3 * V),
        "w1": empty(N_RADIAL, 64), "b1d": empty(64), "b1b": empty(64),
        "w2": empty(64, W), "b2": empty(W),
        "pl0": empty(S + V, Sc + Vg), "pl1": empty(S + 2 * V, Vg),
        "lin20": empty(Sc, Sc), "lin21": empty(Vg, Vg), "sk0": empty(S, Sc), "sk1": empty(V, Vg),
    }
    # scratch: d_pre per atom, the node pass's rows, the pair pass's block
    # partials (in bf16 also the row products' chunk partials, first)
    n_blocks = G * ((N + TS[cdt] - 1) // TS[cdt])
    d_pre = empty(G, N, 3, W)
    rows = empty(G * N, node_row_width(S, V, Sc, Vg))
    n_part = n_blocks * (PART + 64 * W + W)
    if cdt == torch.bfloat16:
        n_part = max(n_part, _row_product_partials(G * N, S, V, Sc, Vg))
    partials = empty(n_part)
    KERNEL.launch(
        _ENTRY[cdt],
        g.data_ptr(), x.data_ptr(), ef.data_ptr(), bf.data_ptr(), bond_src.data_ptr(),
        bond_dst.data_ptr(), agg.data_ptr(), deg.data_ptr(),
        w.w1.data_ptr(), w.b1d.data_ptr(), w.b1b.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
        w.pl0.data_ptr(), w.pl1.data_ptr(), w.lin20.data_ptr(), w.lin21.data_ptr(),
        w.sk0.data_ptr(), w.sk1.data_ptr(),
        d_pre.data_ptr(), rows.data_ptr(), partials.data_ptr(),
        *(out[k].data_ptr() for k in ("dx",) + GRAD_NAMES),
        G, N, B, S, V, Sc, Vg,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return out
