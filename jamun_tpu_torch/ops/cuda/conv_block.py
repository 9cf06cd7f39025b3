"""K2: one whole separable ConvBlock (wrapper + plain twin).

Replaces `packed_separable_conv_layer(fuse_block=True)` of
`jamun_tpu/ops/pallas/packed_conv.py` (pallas_call at line 1495), which the
JAX model reaches through `make_trainable_conv_block`. The CUDA kernel is
`csrc/conv_block.cu`.

Inputs: block input x [G, N, S + 3V] (packed irreps, compute dtype), the
edge features of `edge_features` and the block's weights packed by
`pack_block_weights`. Output: f32 [G, N, Sc + 3Vg] in gate.irreps_out layout.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.edge_features import EF_GEOM
from jamun_tpu_torch.ops.fast_uvu import uvu_messages

__all__ = [
    "BlockWeights", "pack_block_weights", "fused_conv_block", "fused_conv_block_plain",
    "KERNEL", "N_RADIAL", "MAX_WIDTH",
]

N_RADIAL = 32  # the kernel's radial basis size (edge_attr_dim 64)
MAX_WIDTH = 384  # radial MLP output width 2S + 3V the kernel takes (one thread each)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 17 + [_I] * 7 + [_P]
KERNEL = CudaKernel("conv_block", {"conv_block_f32": _ARGS, "conv_block_bf16": _ARGS})
_ENTRY = {torch.float32: "conv_block_f32", torch.bfloat16: "conv_block_bf16"}


class BlockWeights(NamedTuple):
    """One ConvBlock's weights in the kernel's layout ([in, out] matrices)."""

    w1: torch.Tensor  # [nr, 64] cdt: radial rows of the first Dense kernel
    b1d: torch.Tensor  # [64] f32: bias + bondedness-0 embedding @ bond rows
    b1b: torch.Tensor  # [64] f32: bias + bondedness-1 embedding @ bond rows
    w2: torch.Tensor  # [64, 2S + 3V] cdt
    b2: torch.Tensor  # [2S + 3V] f32
    pl0: torch.Tensor  # [S + V, Sc + Vg] cdt: post-linear rows [o1 | o4]
    pl1: torch.Tensor  # [S + 2V, Vg] cdt: post-linear rows [o2 | o3 | o5]
    lin20: torch.Tensor  # [Sc, Sc] cdt
    lin21: torch.Tensor  # [Vg, Vg] cdt
    sk0: torch.Tensor  # [S, Sc] cdt
    sk1: torch.Tensor  # [V, Vg] cdt
    S: int
    V: int
    Sc: int
    Vg: int


def pack_block_weights(radial_nn, post_linear, lin2, skip, bond0, bond1, *, S, V, cdt):
    """Fold the bondedness embeddings into the first radial bias (in f32, as
    `_pack_layer_weights` does) and scale the IrrepsLinear kernels by their
    1/sqrt(fan-in), cast to cdt first."""
    f32 = torch.float32
    d0, d1 = radial_nn.layer(0), radial_nn.layer(1)
    nb = d0.kernel.shape[0] - N_RADIAL
    wb = d0.kernel[:nb].to(f32)
    out = [mi.mul for mi in post_linear.irreps_out]
    if len(out) != 3 or out[1] != out[2]:
        raise NotImplementedError(f"gate shape {post_linear.irreps_out} is not [Sc, Vg, Vg]")
    Sc, Vg = out[0], out[2]

    def lin(module, i_in, i_out):
        fan = module.fan_in[i_out]
        return module.weight(i_in, i_out).to(cdt) / math.sqrt(max(fan, 1))

    in0, in1 = ((0, 3), (1, 2, 4)) if V else ((0,), (1,))
    pl0 = torch.cat([torch.cat([lin(post_linear, i, 0), lin(post_linear, i, 1)], 1) for i in in0])
    pl1 = torch.cat([lin(post_linear, i, 2) for i in in1])
    sk1 = lin(skip, 1, 1) if V else d0.kernel.new_zeros((0, Vg), dtype=cdt)
    return BlockWeights(
        w1=d0.kernel[nb:].to(cdt).contiguous(),
        b1d=(d0.bias.to(f32) + bond0.to(f32) @ wb).contiguous(),
        b1b=(d0.bias.to(f32) + bond1.to(f32) @ wb).contiguous(),
        w2=d1.kernel.to(cdt).contiguous(),
        b2=d1.bias.to(f32).contiguous(),
        pl0=pl0.contiguous(),
        pl1=pl1.contiguous(),
        lin20=lin(lin2, 0, 0).contiguous(),
        lin21=lin(lin2, 1, 1).contiguous(),
        sk0=lin(skip, 0, 0).contiguous(),
        sk1=sk1.contiguous(),
        S=S, V=V, Sc=Sc, Vg=Vg,
    )


def fused_conv_block_plain(x, ef, bf, bond_src, bond_dst, w: BlockWeights) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function with the
    same rounding points (compute dtype at the radial features, h, the
    message weights, the normalised aggregates and the gate outputs; f32
    products and sums everywhere else)."""
    f32, cdt = torch.float32, x.dtype
    S, V, Sc, Vg = w.S, w.V, w.Sc, w.Vg
    G, N, _ = x.shape

    def radial(feat, b1):
        h32 = feat[..., EF_GEOM:].to(f32) @ w.w1.to(f32) + b1
        h = F.silu(h32).to(cdt)
        return (h.to(f32) @ w.w2.to(f32) + w.b2).to(cdt)

    def sh4(feat):
        return torch.cat([torch.ones_like(feat[..., :1]), feat[..., 0:3]], -1).to(f32)

    xf = x.to(f32)
    adj = ef[..., 3].to(f32)
    msg = uvu_messages(xf[:, None], sh4(ef), radial(ef, w.b1d).to(f32), S, V)
    agg = (msg * adj[..., None]).sum(2)
    deg = adj.sum(-1)

    bmask = bf[..., 3].to(f32)
    src = torch.gather(xf, 1, bond_src[..., None].expand(-1, -1, xf.shape[-1]))
    msg_b = uvu_messages(src, sh4(bf), radial(bf, w.b1b).to(f32), S, V) * bmask[..., None]
    agg = agg.scatter_add(1, bond_dst[..., None].expand(-1, -1, msg_b.shape[-1]), msg_b)
    deg = deg.scatter_add(1, bond_dst, bmask)
    norm = (agg * (1.0 / torch.clamp(deg, min=1.0))[..., None]).to(cdt).to(f32)

    o1, o2 = norm[..., :S], norm[..., S : 4 * S].reshape(G, N, S, 3)
    if V:
        o3 = norm[..., 4 * S : 4 * S + 3 * V].reshape(G, N, V, 3)
        o4 = norm[..., 4 * S + 3 * V : 4 * S + 4 * V]
        o5 = norm[..., 4 * S + 4 * V :].reshape(G, N, V, 3)
        in0 = torch.cat([o1, o4], -1)
        in1 = torch.cat([o2, o3, o5], -2)  # [G, N, S + 2V, 3]
    else:
        in0, in1 = o1, o2
    conv0 = in0 @ w.pl0.to(f32)  # [G, N, Sc + Vg]
    conv1 = torch.einsum("gnkc,kq->gnqc", in1, w.pl1.to(f32))  # [G, N, Vg, 3]
    scal = F.leaky_relu(conv0[..., :Sc], 0.01).to(cdt).to(f32)
    gated = (conv1 * torch.sigmoid(conv0[..., Sc:])[..., None]).to(cdt).to(f32)

    out0 = scal @ w.lin20.to(f32) + xf[..., :S] @ w.sk0.to(f32)
    out1 = torch.einsum("gnkc,kq->gnqc", gated, w.lin21.to(f32))
    if V:
        xv = xf[..., S:].reshape(G, N, V, 3)
        out1 = out1 + torch.einsum("gnkc,kq->gnqc", xv, w.sk1.to(f32))
    return torch.cat([out0, out1.reshape(G, N, 3 * Vg)], -1)


def fused_conv_block(x, ef, bf, bond_src, bond_dst, w: BlockWeights) -> torch.Tensor:
    """One ConvBlock -> f32 [G, N, Sc + 3Vg]. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_conv_block_plain(x, ef, bf, bond_src, bond_dst, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_block: unsupported device {x.device}")
    cdt = x.dtype
    if cdt not in _ENTRY:
        raise TypeError(f"fused_conv_block: compute dtype {cdt} not supported")
    G, N, Fdim = x.shape
    B = bond_src.shape[1]
    S, V, Sc, Vg = w.S, w.V, w.Sc, w.Vg
    W = 2 * S + 3 * V
    if W > MAX_WIDTH or ef.shape[-1] != EF_GEOM + N_RADIAL:
        raise NotImplementedError(
            f"fused_conv_block: radial width {W} (max {MAX_WIDTH}) / "
            f"{ef.shape[-1] - EF_GEOM} radial functions (want {N_RADIAL})"
        )
    ec = EF_GEOM + N_RADIAL
    f32 = torch.float32
    checks = [
        ("x", x, cdt, (G, N, S + 3 * V)),
        ("ef", ef, cdt, (G, N, N, ec)),
        ("bf", bf, cdt, (G, B, ec)),
        ("bond_src", bond_src, torch.int64, (G, B)),
        ("bond_dst", bond_dst, torch.int64, (G, B)),
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
                f"fused_conv_block: {name} must be {dt} {shape} contiguous on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty((G, N, Sc + 3 * Vg), dtype=f32, device=x.device)
    KERNEL.launch(
        _ENTRY[cdt],
        x.data_ptr(), ef.data_ptr(), bf.data_ptr(), bond_src.data_ptr(), bond_dst.data_ptr(),
        w.w1.data_ptr(), w.b1d.data_ptr(), w.b1b.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
        w.pl0.data_ptr(), w.pl1.data_ptr(), w.lin20.data_ptr(), w.lin21.data_ptr(),
        w.sk0.data_ptr(), w.sk1.data_ptr(), out.data_ptr(),
        G, N, B, S, V, Sc, Vg,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out
