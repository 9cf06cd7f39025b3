"""K2: one whole separable ConvBlock (wrapper + plain twin), and the
trainable block around it.

Replaces `packed_separable_conv_layer(fuse_block=True)` of
`jamun_tpu/ops/pallas/packed_conv.py` (pallas_call at line 1495), which the
JAX model reaches through `make_trainable_conv_block` (`packed_conv.py:2349`).
The CUDA kernel is `csrc/conv_block.cu`. `conv_block_trainable` is the
counterpart of `make_trainable_conv_block`: a `torch.autograd.Function`
whose forward is K2 and whose backward is K4 (`ops/cuda/conv_block_bwd.py`).

Inputs: block input x [G, N, S + 3V] (packed irreps, compute dtype), the
edge features of `edge_features` and the block's weights packed by
`pack_block_weights`. Output: f32 [G, N, Sc + 3Vg] in gate.irreps_out layout.

`conv_layer` is the kernel's layer mode, the counterpart of
`packed_separable_conv_layer(fuse_block=False)` (`packed_conv.py:1364-1404`),
which JAX's `Conv` runs for a dense call whose fused layer applies
(`jamun_tpu/ops/conv.py:271-315`): the same source with a template flag,
stopping after the post-linear for any l <= 1, even irreps_out with a 0e
block; weights from `layer_weights`, output f32 [G, N, irreps_out.dim] in
irreps order. It has its own launch counter (`LAYER_KERNEL`) and plain twin
(`conv_layer_plain`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.conv_block_bwd import conv_block_bwd
from jamun_tpu_torch.ops.cuda.edge_features import EF_GEOM
from jamun_tpu_torch.ops.fast_uvu import uvu_messages

__all__ = [
    "BlockWeights", "PairFeatures", "block_master_weights", "cast_block_weights", "pack_block_weights",
    "fused_conv_block", "fused_conv_block_plain", "conv_block_residuals_plain",
    "conv_block_trainable", "master_grads", "linear_scales", "rounded_divisor", "pair_sums_plain",
    "LayerWeights", "layer_weights", "conv_layer", "conv_layer_plain",
    "KERNEL", "LAYER_KERNEL", "N_RADIAL", "MAX_WIDTH", "EDGE_FEATURE_ATOMS", "occupancy", "smem_bytes",
    "threads_for", "pair_tiles_bytes", "epilogue_tiles_bytes", "staged_b_bytes", "scratch_bytes",
    "MAX_SMEM", "stage_fits",
]

N_RADIAL = 32  # the kernel's radial basis size (edge_attr_dim 64)
MAX_WIDTH = 384  # radial MLP output width 2S + 3V the kernel takes (one thread each)
EDGE_FEATURE_ATOMS = 128  # up to here K1's edge features and K2 (K4); above, K5

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 19 + [_I] * 7 + [_P]
KERNEL = CudaKernel("conv_block", {
    "conv_block_f32": _ARGS, "conv_block_bf16": _ARGS, "conv_block_occupancy": [_I] * 8 + [_P],
})
_ENTRY = {torch.float32: "conv_block_f32", torch.bfloat16: "conv_block_bf16"}
_LAYER_ARGS = [_P] * 14 + [_I] * 7 + [_P]
LAYER_KERNEL = CudaKernel(
    "conv_layer", {"conv_layer_f32": _LAYER_ARGS, "conv_layer_bf16": _LAYER_ARGS}, source="conv_block"
)
_LAYER_ENTRY = {torch.float32: "conv_layer_f32", torch.bfloat16: "conv_layer_bf16"}
_MATRICES = ("w1", "w2", "pl0", "pl1", "lin20", "lin21", "sk0", "sk1")


# The kernels' shared-memory reckoning, mirrored from csrc/conv_block_body.cuh
# (`scratch_words`, the FMA builds) and csrc/conv_block_mma.cuh /
# csrc/conv_block.cu (`pair_tiles_bytes`, `epilogue_tiles_bytes`,
# `mma_layout`, the bf16 builds); `occupancy` reads the library's own.
# dst atoms per CTA (FMA builds, bf16 builds), pairs per tile, radial hidden width
_TD, _TDM, _PT, _H = 8, 16, 32, 64
MAX_SMEM = 232448  # bytes of shared memory one block may use on the H100
_SM_SMEM = 233472  # bytes of shared memory of one SM (1 KB of it reserved per CTA)


def stage_fits(staged: int, unstaged: int) -> bool:
    """Whether the epilogue stages its B operands (`stage_fits` of
    csrc/conv_block_mma.cuh): the CTA still fits, and as many CTAs share an
    SM as without."""
    return staged <= MAX_SMEM and _SM_SMEM // (staged + 1024) >= _SM_SMEM // (unstaged + 1024)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _ld(k: int) -> int:
    """Leading dimension (bf16 elements) of an operand tile with k columns."""
    return (k + 15) // 16 * 16 + 8


def threads_for(W: int) -> int:
    """Threads of a CTA: one per radial channel, whole warps, at least two."""
    return max((W + 31) // 32 * 32, 64)


def scratch_bytes(N: int, B: int, nt: int, Sc: int, Vg: int, td: int) -> int:
    """The FMA builds' working set (`scratch_words` x 4)."""
    floats = (N_RADIAL * _H + _H * _PT + _PT * N_RADIAL + _PT * 3 + td + td * 3 * nt
              + td * (Sc + Vg) + td * 3 * Vg + td * Sc + td * 3 * Vg)
    return 4 * (floats + 2 * _PT + td * N + B + 1)


def pair_tiles_bytes(W: int, A: int = N_RADIAL) -> int:
    """The bf16 pair loop's tiles: w1 and w2 (n-major), layer 1's input (the
    radial values, or A edge attributes of a sparse slot), h and half a tile
    of message weights."""
    Wp = (W + 7) // 8 * 8
    return (_align16(_H * _ld(A) * 2) + _align16(Wp * _H * 2)
            + _align16(_PT * _ld(A) * 2) + _align16(_PT * _ld(_H) * 2)
            + _align16(16 * _ld(Wp) * 2))


def _comp_rows(td: int) -> int:
    return (3 * td + 15) // 16 * 16


def _bt_bytes(K: int, N: int) -> int:
    """A staged B operand [K][N], n-major: [round_up(N, 8)][ld(K)] bf16."""
    return _align16((N + 7) // 8 * 8 * _ld(K) * 2)


def staged_b_bytes(S: int, V: int, C0: int, V1: int, Sc: int, Vg: int) -> int:
    """The epilogue's staged B operands: the larger of the post-linear's and
    the second linear's and skip's (none in layer mode, Sc = Vg = 0)."""
    post = _bt_bytes(S + V, C0) + _bt_bytes(S + 2 * V, V1)
    second = (_bt_bytes(Sc, Sc) + _bt_bytes(S, Sc) + _bt_bytes(Vg, Vg)
              + (_bt_bytes(V, Vg) if V > 0 else 0)) if Sc + Vg > 0 else 0
    return max(post, second)


def epilogue_tiles_bytes(S: int, V: int, C0: int, V1: int, Sc: int, Vg: int, td: int,
                         stage: bool = False) -> int:
    """The bf16 epilogue's operand tiles and its f32 post-linear results,
    with its staged B operands when `stage`."""
    M1 = _comp_rows(td)
    return (_align16(16 * _ld(S + V) * 2) + _align16(M1 * _ld(S + 2 * V) * 2)
            + _align16(16 * _ld(Sc) * 2) + _align16(16 * _ld(S) * 2)
            + _align16(M1 * _ld(Vg) * 2) + _align16(M1 * _ld(V) * 2)
            + _align16(td * C0 * 4) + _align16(td * 3 * V1 * 4)
            + (staged_b_bytes(S, V, C0, V1, Sc, Vg) if stage else 0))


def smem_bytes(N: int, B: int, S: int, V: int, Sc: int, Vg: int, cdt=torch.bfloat16,
               layer: bool = False) -> int:
    """Bytes of shared memory of one CTA of K2 (or its layer mode, where Sc
    and Vg are C0 and V1) at these sizes."""
    W, F, nt = 2 * S + 3 * V, S + 3 * V, threads_for(2 * S + 3 * V)
    if cdt != torch.bfloat16:
        return scratch_bytes(N, B, nt, Sc, Vg, _TD)
    nl = _TDM * N + B
    persistent = (_align16(_TDM * 3 * nt * 4) + _align16(_TDM * 4) + _align16(_PT * 16)
                  + _align16(_TDM * 4) + _align16((nl + 1) * 4) + _align16(nl * 4))
    pair = pair_tiles_bytes(W) + _align16(_PT * F * 2)
    unstaged, staged = (
        persistent + max(pair, epilogue_tiles_bytes(S, V, Sc, Vg, 0, 0, _TDM, stage) if layer
                         else epilogue_tiles_bytes(S, V, Sc + Vg, Vg, Sc, Vg, _TDM, stage))
        for stage in (False, True)
    )
    return staged if stage_fits(staged, unstaged) else unstaged


def occupancy(N: int, B: int, S: int, V: int, Sc: int, Vg: int, cdt=torch.bfloat16,
              layer: bool = False) -> dict:
    """How the kernel (or its layer mode) is launched at these sizes on the
    current card: threads and bytes of shared memory per CTA, registers and
    local (spill) bytes per thread, CTAs resident per SM."""
    out = (ctypes.c_int * 5)()
    err = KERNEL.fn("conv_block_occupancy")(
        int(cdt == torch.bfloat16), int(layer), N, B, S, V, Sc, Vg, ctypes.addressof(out)
    )
    if err != 0:
        raise RuntimeError(f"conv_block.conv_block_occupancy failed with CUDA error {err}")
    return dict(zip(("threads", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm"), out))


class PairFeatures(NamedTuple):
    """What every ConvBlock of one forward reads besides its input, up to 128
    atoms: the edge features of `edge_features` and the bond lists."""

    ef: torch.Tensor  # [G, N, N, 4 + n_radial] cdt
    bf: torch.Tensor  # [G, B, 4 + n_radial] cdt
    bond_src: torch.Tensor  # [G, B] int64
    bond_dst: torch.Tensor  # [G, B] int64


class BlockWeights(NamedTuple):
    """One ConvBlock's weights in the kernel's layout ([in, out] matrices).

    `pack_block_weights` gives the kernel's operands (matrices in the compute
    dtype, IrrepsLinear kernels scaled by 1/sqrt(fan-in)); the f32 "masters"
    of `block_master_weights` hold the same fields unscaled, and are what
    gradients flow to."""

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

    def tensors(self):
        return tuple(self[:11])


def linear_scales(S: int, V: int, Sc: int, Vg: int) -> dict:
    """sqrt(fan-in) of each IrrepsLinear operand: the summed multiplicity of
    the inputs that share the output's irrep (flax's and `IrrepsLinear`'s)."""
    fans = dict(pl0=S + V, pl1=S + 2 * V, lin20=Sc, lin21=Vg, sk0=S, sk1=V)
    return {k: math.sqrt(max(f, 1)) for k, f in fans.items()}


@functools.lru_cache(maxsize=None)
def rounded_divisor(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`value` rounded to `dtype`, a 0-dim tensor on `device` (JAX's
    `w.astype(cdt) / math.sqrt(fan)` casts the Python float to the array's
    type). Made once per key: a new tensor on the card at every forward
    would cost a host-to-device copy and a stream sync each time."""
    return torch.tensor(value, dtype=dtype, device=device)


def block_master_weights(radial_nn, post_linear, lin2, skip, bond0, bond1, *, S, V) -> BlockWeights:
    """The block's parameters gathered into the kernel's layout in f32 (the
    IrrepsLinear kernels unscaled), differentiable in the parameters. The
    bondedness embeddings fold into the first radial bias here, outside the
    kernels, as `_pack_layer_weights` does, so their gradients and those of
    the bond rows of the first Dense kernel come out by the chain rule."""
    f32 = torch.float32
    d0, d1 = radial_nn.layer(0), radial_nn.layer(1)
    nb = d0.kernel.shape[0] - N_RADIAL
    wb = d0.kernel[:nb].to(f32)
    out = [mi.mul for mi in post_linear.irreps_out]
    if len(out) != 3 or out[1] != out[2]:
        raise NotImplementedError(
            f"gate shape {post_linear.irreps_out} is not [Sc, Vg, Vg]; see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
        )
    Sc, Vg = out[0], out[2]

    def lin(module, i_in, i_out):
        return module.weight(i_in, i_out).to(f32)

    in0, in1 = ((0, 3), (1, 2, 4)) if V else ((0,), (1,))
    return BlockWeights(
        w1=d0.kernel[nb:].to(f32),
        b1d=d0.bias.to(f32) + bond0.to(f32) @ wb,
        b1b=d0.bias.to(f32) + bond1.to(f32) @ wb,
        w2=d1.kernel.to(f32),
        b2=d1.bias.to(f32),
        pl0=torch.cat([torch.cat([lin(post_linear, i, 0), lin(post_linear, i, 1)], 1) for i in in0]),
        pl1=torch.cat([lin(post_linear, i, 2) for i in in1]),
        lin20=lin(lin2, 0, 0),
        lin21=lin(lin2, 1, 1),
        sk0=lin(skip, 0, 0),
        sk1=lin(skip, 1, 1) if V else d0.kernel.new_zeros((0, Vg), dtype=f32),
        S=S, V=V, Sc=Sc, Vg=Vg,
    )


def cast_block_weights(m: BlockWeights, cdt) -> BlockWeights:
    """The kernel's operands from the f32 masters: matrices cast to cdt, each
    IrrepsLinear kernel then divided by sqrt(fan-in) in cdt, the divisor
    itself rounded to cdt (JAX's `w.astype(cdt) / math.sqrt(fan)` in
    `_pack_layer_weights` and `packed_conv_block_bwd` casts the Python float
    to the array's type); biases stay f32."""
    scales = linear_scales(m.S, m.V, m.Sc, m.Vg)
    fields = m._asdict()
    for k in _MATRICES:
        t = fields[k].to(cdt)
        if k in scales:
            t = t / rounded_divisor(scales[k], cdt, t.device)
        fields[k] = t.contiguous()
    for k in ("b1d", "b1b", "b2"):
        fields[k] = fields[k].contiguous()
    return BlockWeights(**fields)


def pack_block_weights(radial_nn, post_linear, lin2, skip, bond0, bond1, *, S, V, cdt):
    """The kernel's operands for one block (`block_master_weights`, then
    `cast_block_weights`)."""
    return cast_block_weights(
        block_master_weights(radial_nn, post_linear, lin2, skip, bond0, bond1, S=S, V=V), cdt
    )


def _radial_plain(feat, w1, b1, w2, b2, cdt):
    """The radial MLP on edge features [..., EC] with its rounding points:
    h and the message weights in cdt, f32 products and sums."""
    f32 = torch.float32
    h32 = feat[..., EF_GEOM:].to(f32) @ w1.to(f32) + b1
    h = F.silu(h32).to(cdt)
    return (h.to(f32) @ w2.to(f32) + b2).to(cdt)


def _sh4(feat):
    return torch.cat([torch.ones_like(feat[..., :1]), feat[..., 0:3]], -1).to(torch.float32)


def pair_sums_plain(x, ef, w1, b1, w2, b2, S: int, V: int):
    """The dense pairs' messages summed per destination atom, [G, N, 4S + 7V]
    f32 in the uvu layout, and their degree [G, N] f32, from K1's edge
    features ef [G, N, N, EC]: the radial MLP (first layer w1 [NR, 64] on the
    radial basis, b1 with the bondedness-0 block folded in), then the uvu
    messages of the sources, masked by the adjacency."""
    f32 = torch.float32
    adj = ef[..., 3].to(f32)
    w = _radial_plain(ef, w1, b1, w2, b2, x.dtype).to(f32)
    msg = uvu_messages(x.to(f32)[:, None], _sh4(ef), w, S, V)
    return (msg * adj[..., None]).sum(2), adj.sum(-1)


def _aggregate_plain(x, ef, bf, bond_src, bond_dst, w: BlockWeights):
    """The normalised aggregates in the uvu layout [G, N, 4S + 7V] (rounded
    to the compute dtype, held in f32) and the degree [G, N]."""
    f32, cdt = torch.float32, x.dtype
    S, V = w.S, w.V
    xf = x.to(f32)
    agg, deg = pair_sums_plain(x, ef, w.w1, w.b1d, w.w2, w.b2, S, V)

    bmask = bf[..., 3].to(f32)
    src = torch.gather(xf, 1, bond_src[..., None].expand(-1, -1, xf.shape[-1]))
    w_b = _radial_plain(bf, w.w1, w.b1b, w.w2, w.b2, cdt).to(f32)
    msg_b = uvu_messages(src, _sh4(bf), w_b, S, V) * bmask[..., None]
    agg = agg.scatter_add(1, bond_dst[..., None].expand(-1, -1, msg_b.shape[-1]), msg_b)
    deg = deg.scatter_add(1, bond_dst, bmask)
    norm = (agg * (1.0 / torch.clamp(deg, min=1.0))[..., None]).to(cdt).to(f32)
    return norm, deg


def _channel_major(norm: torch.Tensor, S: int, V: int) -> torch.Tensor:
    """uvu layout [G, N, 4S + 7V] -> the kernels' residual layout
    [G, N, 3, 2S + 3V]: [component, radial channel], zero where a channel
    has no such component."""
    G, N = norm.shape[:2]
    out = norm.new_zeros((G, N, 3, 2 * S + 3 * V))
    vec = lambda a, n: a.reshape(G, N, n, 3).transpose(-1, -2)  # noqa: E731
    out[:, :, 0, :S] = norm[..., :S]
    out[:, :, :, S : 2 * S] = vec(norm[..., S : 4 * S], S)
    if V:
        o = 4 * S
        out[:, :, :, 2 * S : 2 * S + V] = vec(norm[..., o : o + 3 * V], V)
        out[:, :, 0, 2 * S + V : 2 * S + 2 * V] = norm[..., o + 3 * V : o + 4 * V]
        out[:, :, :, 2 * S + 2 * V :] = vec(norm[..., o + 4 * V :], V)
    return out


def conv_block_residuals_plain(x, ef, bf, bond_src, bond_dst, w: BlockWeights):
    """What K2 saves for the backward: the normalised aggregates
    [G, N, 3, 2S + 3V] f32 (rounded to the compute dtype) and the degree
    [G, N] f32."""
    norm, deg = _aggregate_plain(x, ef, bf, bond_src, bond_dst, w)
    return _channel_major(norm, w.S, w.V), deg


def fused_conv_block_plain(x, ef, bf, bond_src, bond_dst, w: BlockWeights) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function with the
    same rounding points (compute dtype at the radial features, h, the
    message weights, the normalised aggregates and the gate outputs; f32
    products and sums everywhere else)."""
    return _epilogue_plain(x, _aggregate_plain(x, ef, bf, bond_src, bond_dst, w)[0], w)


def _epilogue_plain(x, norm, w: BlockWeights) -> torch.Tensor:
    """Post-linear, gate, linear and skip on the normalised aggregates."""
    f32, cdt = torch.float32, x.dtype
    S, V, Sc, Vg = w.S, w.V, w.Sc, w.Vg
    G, N, _ = x.shape
    xf = x.to(f32)
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


def fused_conv_block(x, ef, bf, bond_src, bond_dst, w: BlockWeights, residuals: bool = False):
    """One ConvBlock -> f32 [G, N, Sc + 3Vg]. CPU tensors take the plain
    version; CUDA tensors launch the kernel. With `residuals=True` also
    returns what the backward reads: (out, aggregates [G, N, 3, 2S + 3V],
    degree [G, N])."""
    if x.device.type == "cpu":
        norm, deg = _aggregate_plain(x, ef, bf, bond_src, bond_dst, w)
        out = _epilogue_plain(x, norm, w)
        return (out, _channel_major(norm, w.S, w.V), deg) if residuals else out
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
            f"{ef.shape[-1] - EF_GEOM} radial functions (want {N_RADIAL}); see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
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
    agg = deg = None
    if residuals:
        agg = torch.empty((G, N, 3, W), dtype=f32, device=x.device)
        deg = torch.empty((G, N), dtype=f32, device=x.device)
    KERNEL.launch(
        _ENTRY[cdt],
        x.data_ptr(), ef.data_ptr(), bf.data_ptr(), bond_src.data_ptr(), bond_dst.data_ptr(),
        w.w1.data_ptr(), w.b1d.data_ptr(), w.b1b.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
        w.pl0.data_ptr(), w.pl1.data_ptr(), w.lin20.data_ptr(), w.lin21.data_ptr(),
        w.sk0.data_ptr(), w.sk1.data_ptr(), out.data_ptr(),
        agg.data_ptr() if residuals else None, deg.data_ptr() if residuals else None,
        G, N, B, S, V, Sc, Vg,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return (out, agg, deg) if residuals else out


class _TrainableConvBlock(torch.autograd.Function):
    """Forward K2 (saving its aggregates and degree), backward K4. The weight
    inputs are the f32 masters: the cast to the compute dtype and the
    1/sqrt(fan-in) scale happen inside, so the weight gradients stay f32 as
    the JAX VJP returns them (`packed_conv.py:2290-2345`). The edge features
    and bond indices get no gradient (JAX returns zeros for them)."""

    @staticmethod
    def forward(ctx, x, ef, bf, bond_src, bond_dst, shape, *masters):
        w = cast_block_weights(BlockWeights(*masters, *shape), x.dtype)
        out, agg, deg = fused_conv_block(x, ef, bf, bond_src, bond_dst, w, residuals=True)
        ctx.save_for_backward(x, ef, bf, bond_src, bond_dst, agg, deg, *w.tensors())
        ctx.shape = shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, ef, bf, bond_src, bond_dst, agg, deg, *wt = ctx.saved_tensors
        w = BlockWeights(*wt, *ctx.shape)
        dx, d_masters = master_grads(g, x, ef, bf, bond_src, bond_dst, w, agg, deg)
        return (dx, None, None, None, None, None, *d_masters)


def master_grads(g, x, ef, bf, bond_src, bond_dst, w: BlockWeights, agg, deg):
    """K4 on the packed weights `w`, its gradients taken back to the f32
    masters: (dx in x's dtype, [d_master per `BlockWeights` tensor field])."""
    grads = conv_block_bwd(g.contiguous(), x, ef, bf, bond_src, bond_dst, w, agg, deg)
    # the VJP divides by the f32 sqrt(fan-in), as `packed_conv_block_bwd`
    # does (`packed_conv.py:2317`), whatever the forward's rounded divisor
    scales = linear_scales(w.S, w.V, w.Sc, w.Vg)
    d_masters = [
        grads[k] / scales[k] if k in scales else grads[k] for k in BlockWeights._fields[:11]
    ]
    return grads["dx"].to(x.dtype), d_masters


def conv_block_trainable(x, ef, bf, bond_src, bond_dst, masters: BlockWeights) -> torch.Tensor:
    """`fused_conv_block` on the f32 masters of `block_master_weights`,
    differentiable in x and every master (counterpart of
    `make_trainable_conv_block`)."""
    shape = (masters.S, masters.V, masters.Sc, masters.Vg)
    return _TrainableConvBlock.apply(x, ef, bf, bond_src, bond_dst, shape, *masters.tensors())


class LayerWeights(NamedTuple):
    """One Conv's weights for K2's layer mode ([in, out] matrices): the
    radial MLP as in `BlockWeights`, and the post-linear for a general
    l <= 1 irreps_out, each IrrepsLinear kernel cast to the compute dtype and
    divided there by sqrt(fan-in) (`_pack_layer_weights` with
    fuse_block=False)."""

    w1: torch.Tensor  # [nr, 64] cdt
    b1d: torch.Tensor  # [64] f32: bias + bondedness-0 embedding @ bond rows
    b1b: torch.Tensor  # [64] f32: bias + bondedness-1 embedding @ bond rows
    w2: torch.Tensor  # [64, 2S + 3V] cdt
    b2: torch.Tensor  # [2S + 3V] f32
    pl0: torch.Tensor  # [S + V, C0] cdt: rows [o1 | o4], columns the 0e outputs in order
    pl1: torch.Tensor  # [S + 2V, V1] cdt: rows [o2 | o3 | o5], columns the 1e outputs
    out_blocks: tuple  # ((mul, l), ...) of irreps_out
    S: int
    V: int
    C0: int
    V1: int


def layer_weights(radial_nn, post_linear, bond0, bond1, *, S: int, V: int, cdt) -> LayerWeights:
    """K2 layer mode's operands for one Conv, from its parameters."""
    f32 = torch.float32
    d0, d1 = radial_nn.layer(0), radial_nn.layer(1)
    nb = d0.kernel.shape[0] - N_RADIAL
    wb = d0.kernel[:nb].to(f32)
    outs = list(post_linear.irreps_out)
    j0 = [j for j, mi in enumerate(outs) if mi.ir.l == 0]
    j1 = [j for j, mi in enumerate(outs) if mi.ir.l == 1]
    in0, in1 = ((0, 3), (1, 2, 4)) if V else ((0,), (1,))

    def rows(ids, js):
        return torch.cat([
            torch.cat([post_linear.weight(i, j).to(cdt) for j in js], 1)
            if js else d0.kernel.new_zeros((post_linear.irreps_in[i].mul, 0), dtype=cdt)
            for i in ids
        ])

    def scaled(m, fan):
        return (m / rounded_divisor(math.sqrt(max(fan, 1)), cdt, m.device)).contiguous()

    return LayerWeights(
        w1=d0.kernel[nb:].to(cdt).contiguous(),
        b1d=(d0.bias.to(f32) + bond0.to(f32) @ wb).contiguous(),
        b1b=(d0.bias.to(f32) + bond1.to(f32) @ wb).contiguous(),
        w2=d1.kernel.to(cdt).contiguous(),
        b2=d1.bias.to(f32).contiguous(),
        pl0=scaled(rows(in0, j0), S + V),
        pl1=scaled(rows(in1, j1), S + 2 * V),
        out_blocks=tuple((mi.mul, mi.ir.l) for mi in outs),
        S=S, V=V,
        C0=sum(outs[j].mul for j in j0), V1=sum(outs[j].mul for j in j1),
    )


def _out_columns_list(out_blocks) -> list:
    """The irreps-order column of each 0e output channel, then of the first
    component of each 1e output channel."""
    c0, c1, off = [], [], 0
    for mul, l in out_blocks:
        if l == 0:
            c0 += range(off, off + mul)
        else:
            c1 += range(off, off + 3 * mul, 3)
        off += mul * (2 * l + 1)
    return c0 + c1


@functools.lru_cache(maxsize=None)
def _out_columns(out_blocks: tuple, device: torch.device) -> torch.Tensor:
    """`_out_columns_list` as an int32 tensor on `device`, made once per key
    (a new tensor at every call would be a host-to-device copy each time)."""
    return torch.tensor(_out_columns_list(out_blocks), dtype=torch.int32, device=device)


def conv_layer_plain(x, ef, bf, bond_src, bond_dst, w: LayerWeights) -> torch.Tensor:
    """The plain PyTorch version of K2's layer mode: K2's aggregates (the
    same rounding points), then the post-linear in f32, the output
    [G, N, C0 + 3 V1] f32 in irreps order."""
    f32 = torch.float32
    S, V = w.S, w.V
    G, N, _ = x.shape
    norm, _ = _aggregate_plain(x, ef, bf, bond_src, bond_dst, w)
    o2 = norm[..., S : 4 * S].reshape(G, N, S, 3)
    if V:
        o3 = norm[..., 4 * S : 4 * S + 3 * V].reshape(G, N, V, 3)
        o5 = norm[..., 4 * S + 4 * V :].reshape(G, N, V, 3)
        in0 = torch.cat([norm[..., :S], norm[..., 4 * S + 3 * V : 4 * S + 4 * V]], -1)
        in1 = torch.cat([o2, o3, o5], -2)
    else:
        in0, in1 = norm[..., :S], o2
    conv0 = in0 @ w.pl0.to(f32)  # [G, N, C0]
    conv1 = torch.einsum("gnkc,kq->gnqc", in1, w.pl1.to(f32))  # [G, N, V1, 3]
    parts, q0, q1 = [], 0, 0
    for mul, l in w.out_blocks:
        if l == 0:
            parts.append(conv0[..., q0 : q0 + mul])
            q0 += mul
        else:
            parts.append(conv1[..., q1 : q1 + mul, :].reshape(G, N, 3 * mul))
            q1 += mul
    return torch.cat(parts, -1)


def conv_layer(x, ef, bf, bond_src, bond_dst, w: LayerWeights) -> torch.Tensor:
    """One Conv on dense pairs and bonds, the mean and the post-linear ->
    f32 [G, N, irreps_out.dim]. CPU tensors take the plain version; CUDA
    tensors launch K2 in its layer mode. Forward only, as in JAX."""
    if x.device.type == "cpu":
        return conv_layer_plain(x, ef, bf, bond_src, bond_dst, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv_layer: unsupported device {x.device}")
    cdt = x.dtype
    if cdt not in _LAYER_ENTRY:
        raise TypeError(f"conv_layer: compute dtype {cdt} not supported")
    G, N, _ = x.shape
    B = bond_src.shape[1]
    S, V, C0, V1 = w.S, w.V, w.C0, w.V1
    W = 2 * S + 3 * V
    if W > MAX_WIDTH or ef.shape[-1] != EF_GEOM + N_RADIAL:
        raise NotImplementedError(
            f"conv_layer: radial width {W} (max {MAX_WIDTH}) / {ef.shape[-1] - EF_GEOM} radial "
            f"functions (want {N_RADIAL}); see "
            "ROADMAP.md queue A, 'Kernel shapes outside the configurations'"
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
        ("pl0", w.pl0, cdt, (S + V, C0)),
        ("pl1", w.pl1, cdt, (S + 2 * V, V1)),
    ]
    for name, t, dt, shape in checks:
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"conv_layer: {name} must be {dt} {shape} contiguous on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    cols = _out_columns(w.out_blocks, x.device)
    out = torch.empty((G, N, C0 + 3 * V1), dtype=f32, device=x.device)
    LAYER_KERNEL.launch(
        _LAYER_ENTRY[cdt],
        x.data_ptr(), ef.data_ptr(), bf.data_ptr(), bond_src.data_ptr(), bond_dst.data_ptr(),
        w.w1.data_ptr(), w.b1d.data_ptr(), w.b1b.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
        w.pl0.data_ptr(), w.pl1.data_ptr(), cols.data_ptr(), out.data_ptr(),
        G, N, B, S, V, C0, V1,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out
