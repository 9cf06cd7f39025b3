"""EquiFold's l <= 1 modules on dense masked pairs (counterpart of
`jamun_tpu/ops/contrib/equifold.py`).

Scalars s [..., S] and vectors v [..., V, 3] (channel axis before the
component axis). Nodes are padded [G, N, ...]; pair quantities are
dst-major [G, N_dst, N_src, ...] with a boolean `pair_mask` in place of an
edge list: the scatter softmax over each destination's edges becomes a
masked softmax over the source axis, the scatter sum a masked sum.
Parameters carry flax's names and shapes (`w_s` [out, in], `b_s` [out],
`w_v` [out, in]; per head [H, out, in]), so `params.from_jax_params` maps a
JAX tree onto these modules one to one. Plain PyTorch, as JAX's runs XLA:
no TPU kernel reaches it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from jamun_tpu_torch.ops.mlp import Dense

__all__ = [
    "SVLinear",
    "SVLayerNorm",
    "BesselBasis",
    "SinusoidalBasis",
    "RadialNN",
    "DTPByHead",
    "Equiformer",
    "Convnet",
]

_NEG_INF = -1e9


def _xavier_(p: torch.Tensor, generator: torch.Generator, gain: float = 1.0) -> None:
    """flax's xavier-uniform of the JAX modules on a [..., out, in] weight."""
    bound = gain * math.sqrt(6.0 / (p.shape[-1] + p.shape[-2]))
    p.data.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class _XavierDense(Dense):
    """flax's Dense as the radial network builds it: xavier-uniform kernel
    [in, out], zero bias."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_(self.kernel, generator)
        self.bias.data.zero_()


class SVLinear(nn.Module):
    """Channel-mixing linear on (s, v): separate [out, in] weights for the
    scalars and the vectors (no bias on vectors: equivariance)."""

    def __init__(self, nc_s_in: int, nc_s_out: int, nc_v_in: int, nc_v_out: int, add_bias: bool = False):
        super().__init__()
        assert nc_s_out > 0 or nc_v_out > 0
        if nc_s_out > 0:
            self.w_s = _param(nc_s_out, nc_s_in)
            if add_bias:
                self.b_s = _param(nc_s_out)
        if nc_v_out > 0:
            self.w_v = _param(nc_v_out, nc_v_in)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("w_s", "w_v"):
            if hasattr(self, name):
                _xavier_(getattr(self, name), generator)
        if hasattr(self, "b_s"):
            self.b_s.data.zero_()

    def forward(self, s, v):
        s_out = v_out = None
        if hasattr(self, "w_s"):
            s_out = torch.einsum("ij,...j->...i", self.w_s.to(s.dtype), s)
            if hasattr(self, "b_s"):
                s_out = s_out + self.b_s.to(s_out.dtype)
        if hasattr(self, "w_v"):
            v_out = torch.einsum("ij,...jk->...ik", self.w_v.to(v.dtype), v)
        return s_out, v_out


class SVLayerNorm(nn.Module):
    """Equiformer's layer norm on (s, v): mean and RMS over the scalar
    channels, the RMS over vector channels and components for the vectors
    (normalized by the channel count)."""

    def __init__(self, nc_s: int, nc_v: int, eps: float = 1e-6):
        super().__init__()
        self.nc_v, self.eps = nc_v, eps
        self.gamma_s = nn.Parameter(torch.ones(nc_s))
        self.beta_s = nn.Parameter(torch.zeros(nc_s))
        self.gamma_v = nn.Parameter(torch.ones(nc_v))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.gamma_s.data.fill_(1.0)
        self.beta_s.data.zero_()
        self.gamma_v.data.fill_(1.0)

    def forward(self, s, v):
        x = s - s.mean(dim=-1, keepdim=True)
        rms = torch.sqrt((x * x).mean(dim=-1, keepdim=True) + self.eps)
        s = self.gamma_s.to(s.dtype) * x / rms + self.beta_s.to(s.dtype)
        sq = (v * v).sum(dim=(-1, -2), keepdim=True) / self.nc_v
        v = self.gamma_v.to(v.dtype)[..., :, None] * v / torch.sqrt(sq + self.eps)
        return s, v


class BesselBasis(nn.Module):
    """Bessel radial basis with trainable frequencies (n pi / rc at first)."""

    def __init__(self, rc: float, radial_num_basis: int = 16):
        super().__init__()
        self.rc, self.n = rc, radial_num_basis
        self.bessel_weights = nn.Parameter(torch.empty(radial_num_basis))
        self.reset_parameters(None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.bessel_weights.data.copy_(torch.linspace(1.0, float(self.n), self.n) * math.pi)

    def forward(self, r):
        arg = self.bessel_weights.to(r.dtype) * r[..., None] / self.rc
        return (2.0 / self.rc) * torch.sin(arg)


class SinusoidalBasis(nn.Module):
    """sin / cos basis on [0, xmax] (no parameters)."""

    def __init__(self, xmax: float, d: int = 32):
        super().__init__()
        assert d % 2 == 0
        self.xmax, self.d = xmax, d

    def forward(self, x):
        freqs = torch.linspace(1.0, self.d // 2, self.d // 2, dtype=x.dtype, device=x.device) * math.pi
        arg = freqs * x[..., None] / self.xmax
        return (2.0 / self.xmax) * torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


class RadialNN(nn.Module):
    """basis(r) (++ edge features ++ time features) -> SiLU MLP of
    `radial_num_layers` hidden layers. flax infers the first layer's width
    from its input; here `num_edge_features` and `num_ts_features` give the
    widths of the optional `edges` and `ts` inputs."""

    def __init__(
        self, num_out_features: int, rc: float, radial_num_basis: int = 16,
        radial_num_hidden: int = 16, radial_num_layers: int = 2, basis_type: str = "bessel",
        num_edge_features: int = 0, num_ts_features: int = 0,
    ):
        super().__init__()
        if basis_type == "bessel":
            self.BesselBasis_0 = BesselBasis(rc, radial_num_basis)
        elif basis_type == "sinusoidal":
            self.basis = SinusoidalBasis(rc, radial_num_basis)
        else:
            raise ValueError(f"unknown basis_type {basis_type!r}")
        widths = [radial_num_basis + num_edge_features + num_ts_features]
        widths += [radial_num_hidden] * radial_num_layers + [num_out_features]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", _XavierDense(widths[i], widths[i + 1]))

    def forward(self, r, edges=None, ts=None):
        feats = self.BesselBasis_0(r) if hasattr(self, "BesselBasis_0") else self.basis(r)
        parts = [feats] + [t.to(feats.dtype) for t in (edges, ts) if t is not None]
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else feats
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.silu(x)
        return x


class DTPByHead(nn.Module):
    """Per-head depthwise product with the edge direction, then a per-head
    linear. s [..., H, M], v [..., H, M, 3], the unit edge vector rvec
    [..., 3] and external weights [..., 4 M H] (the w_ss / w_sv / w_vs /
    w_vv gains)."""

    def __init__(self, nc_in: int, nc_s_out: int, nc_v_out: int, num_heads: int):
        super().__init__()
        self.M, self.H = nc_in, num_heads
        self.w_s = _param(num_heads, nc_s_out, 2 * nc_in)
        self.b_s = _param(num_heads, nc_s_out)
        self.w_v = _param(num_heads, nc_v_out, 2 * nc_in)

    @property
    def weight_numel(self) -> int:
        return 4 * self.M * self.H

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_(self.w_s, generator)
        _xavier_(self.w_v, generator)
        self.b_s.data.zero_()

    def forward(self, s, v, rvec, weights):
        w = weights.reshape(weights.shape[:-1] + (4, self.H, self.M))
        w_ss, w_sv, w_vs, w_vv = w.unbind(-3)
        r = rvec[..., None, None, :]
        s_cat = torch.cat([w_ss * s, w_vv * (v * r).sum(dim=-1)], dim=-1)  # [..., H, 2M]
        v_cat = torch.cat([w_sv[..., None] * s[..., None] * r, w_vs[..., None] * v], dim=-2)
        s_out = torch.einsum("hmn,...hn->...hm", self.w_s.to(s_cat.dtype), s_cat) + self.b_s.to(s_cat.dtype)
        v_out = torch.einsum("hmn,...hnk->...hmk", self.w_v.to(v_cat.dtype), v_cat)
        return s_out, v_out


def _masked_softmax_over_src(z, pair_mask):
    """The softmax over the last (source) axis restricted to valid pairs;
    a row with no valid source gives all-zero weights."""
    z = torch.where(pair_mask, z, torch.full_like(z, _NEG_INF))
    z = z - z.amax(dim=-1, keepdim=True).detach()
    ez = torch.exp(z) * pair_mask.to(z.dtype)
    return ez / torch.clamp(ez.sum(dim=-1, keepdim=True), min=1e-20)


def _mask_geometry(pair_mask, r, rvec):
    """Masked pairs may carry non-finite geometry (rvec = d / |d| on the
    self pair): zero it, so that no masked sum meets NaN * 0."""
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where(pair_mask, r, zero), torch.where(pair_mask[..., None], rvec, zero)


class Equiformer(nn.Module):
    """The Equiformer block (Fig. 1b) on dense masked pairs. forward(s
    [G, N, S], v [G, N, V, 3] (S == V), pair_mask [G, N, N] bool, r
    [G, N, N], rvec [G, N, N, 3], weight_cutoff [G, N, N] or None, edges
    [G, N, N, E] or None, ts or None) -> (s, v); i = dst on axis 1, j = src
    on axis 2. `radial_nn(num_out_features=...)` builds the radial network
    (a `RadialNN`, say), named as flax names it."""

    def __init__(
        self, nc_s: int, nc_v: int, radial_nn: Callable[..., nn.Module], num_heads: int = 1,
        apply_layer_norm: bool = True, apply_resnet: bool = True, ff_mul: int = 3,
        nc_s_out: Optional[int] = None, nc_v_out: Optional[int] = None,
    ):
        super().__init__()
        assert nc_s == nc_v, "the reference assumes nc_s == nc_v"
        S, H = nc_s, num_heads
        M = S // H  # channels per head
        self.S, self.H, self.M = S, H, M
        self.apply_layer_norm, self.apply_resnet = apply_layer_norm, apply_resnet
        self.nc_s_out = S if nc_s_out is None else nc_s_out
        nc_v_out = S if nc_v_out is None else nc_v_out
        m = ff_mul
        if apply_layer_norm:
            self.layer_norm_attn = SVLayerNorm(S, S)
            self.layer_norm_ff = SVLayerNorm(S, S)
        self.linear_dst = SVLinear(S, S, S, S, add_bias=True)
        self.linear_src = SVLinear(S, S, S, S, add_bias=True)
        self.w_s_init = _param(H, 2 * M, 2 * M * M)
        self.b_s_init = _param(H, 2 * M)
        self.w_v_init = _param(H, 2 * M, 2 * M * M)
        self.pre_attn_dtp_linear = DTPByHead(2 * M, 3 * M, M, H)
        radial = radial_nn(num_out_features=self.pre_attn_dtp_linear.weight_numel)
        self._radial_name = f"{type(radial).__name__}_0"
        self.add_module(self._radial_name, radial)
        self.attn_msg_w_s = _param(H, M, 2 * M)
        self.attn_msg_b_s = _param(H, M)
        self.attn_msg_w_v = _param(H, M, 2 * M)
        self.attn_w = _param(H, M)
        self.linear_attn_final = SVLinear(S, S, S, S, add_bias=True)
        self.ff1 = SVLinear(S, m * self.nc_s_out + m * nc_v_out, S, m * nc_v_out, add_bias=True)
        self.ff2 = SVLinear(m * self.nc_s_out, self.nc_s_out, m * nc_v_out, nc_v_out, add_bias=True)
        self.ff_mul = m

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("w_s_init", "w_v_init", "attn_msg_w_s", "attn_msg_w_v"):
            _xavier_(getattr(self, name), generator)
        _xavier_(self.attn_w, generator, gain=math.sqrt(2.0 / (1.0 + 0.1**2)))
        for name in ("b_s_init", "attn_msg_b_s"):
            getattr(self, name).data.zero_()

    def forward(self, s, v, pair_mask, r, rvec, weight_cutoff=None, edges=None, ts=None):
        S, H, M = self.S, self.H, self.M
        G, N = s.shape[0], s.shape[1]
        r, rvec = _mask_geometry(pair_mask, r, rvec)

        s0, v0 = s, v
        if self.apply_layer_norm:
            s, v = self.layer_norm_attn(s, v)

        # initial mixing: separate dst and src linears, all-against-all product per head
        s_i, v_i = self.linear_dst(s, v)
        s_j, v_j = self.linear_src(s, v)
        s_i, v_i = s_i.reshape(G, N, H, M), v_i.reshape(G, N, H, M, 3)
        s_j, v_j = s_j.reshape(G, N, H, M), v_j.reshape(G, N, H, M, 3)
        MM = M * M
        ss = torch.einsum("gihm,gjhn->gijhmn", s_i, s_j).reshape(G, N, N, H, MM)
        vv = torch.einsum("gihmk,gjhnk->gijhmn", v_i, v_j).reshape(G, N, N, H, MM)
        sv = torch.einsum("gihm,gjhnk->gijhmnk", s_i, v_j).reshape(G, N, N, H, MM, 3)
        vs = torch.einsum("gihmk,gjhn->gijhmnk", v_i, s_j).reshape(G, N, N, H, MM, 3)
        s_ij = torch.cat([ss, vv], dim=-1)  # [G, N, N, H, 2MM]
        v_ij = torch.cat([sv, vs], dim=-2)
        s_ij = torch.einsum("hmn,gijhn->gijhm", self.w_s_init.to(s_ij.dtype), s_ij) + self.b_s_init.to(
            s_ij.dtype)
        v_ij = torch.einsum("hmn,gijhnk->gijhmk", self.w_v_init.to(v_ij.dtype), v_ij)

        # the pre-attention product with the edge direction
        weights = getattr(self, self._radial_name)(r, edges, ts)  # [G, N, N, 4 * 2M * H]
        s_ij, v_ij = self.pre_attn_dtp_linear(s_ij, v_ij, rvec, weights)  # [.., H, 3M], [.., H, M, 3]
        s_ij0, gate_v, s_msg = s_ij[..., :M], s_ij[..., M : 2 * M], s_ij[..., 2 * M :]

        # messages
        s_msg = F.silu(s_msg)
        v_ij = torch.sigmoid(gate_v)[..., None] * v_ij
        rv = rvec[..., None, None, :]
        s_cat = torch.cat([s_msg, (v_ij * rv).sum(dim=-1)], dim=-1)  # [G, N, N, H, 2M]
        v_cat = torch.cat([s_msg[..., None] * rv, v_ij], dim=-2)  # [G, N, N, H, 2M, 3]
        s_ij = torch.einsum("hmn,gijhn->gijhm", self.attn_msg_w_s.to(s_cat.dtype), s_cat) + \
            self.attn_msg_b_s.to(s_cat.dtype)
        v_ij = torch.einsum("hmn,gijhnk->gijhmk", self.attn_msg_w_v.to(v_cat.dtype), v_cat)

        # attention over the incoming edges of each destination
        z = F.softplus(torch.einsum("hn,gijhn->gijh", self.attn_w.to(s_ij0.dtype), s_ij0))
        if weight_cutoff is not None:
            z = weight_cutoff[..., None] * z
        a = _masked_softmax_over_src(z.movedim(-1, 2), pair_mask[:, :, None, :]).movedim(2, -1)

        s_agg = torch.einsum("gijh,gijhm->gihm", a, s_ij).reshape(G, N, S)
        v_agg = torch.einsum("gijh,gijhmk->gihmk", a, v_ij).reshape(G, N, S, 3)
        s, v = self.linear_attn_final(s_agg, v_agg)
        s, v = s0 + s, v0 + v

        # feed-forward
        if self.apply_resnet:
            s0, v0 = s, v
        if self.apply_layer_norm:
            s, v = self.layer_norm_ff(s, v)
        s, v = self.ff1(s, v)
        if self.nc_s_out > 0:
            off = self.ff_mul * self.nc_s_out
            gate_v, s = s[..., off:], F.silu(s[..., :off])
        else:
            gate_v, s = s, None
        v = torch.sigmoid(gate_v)[..., None] * v
        s, v = self.ff2(s, v)
        if self.apply_resnet:
            s = s0 + s if s is not None else None
            v = v0 + v
        return s, v


class Convnet(nn.Module):
    """The two-stage gated product convolution on dense masked pairs; the
    same forward signature as `Equiformer`. The masked sum over sources is
    divided by `div_factor` (> 0)."""

    def __init__(
        self, nc_s: int, nc_v: int, radial_nn: Callable[..., nn.Module], div_factor: float = 1.0,
        nc_s_out: Optional[int] = None, nc_v_out: Optional[int] = None,
    ):
        super().__init__()
        assert nc_s == nc_v
        assert div_factor > 0.0
        S = nc_s
        self.S, self.div_factor = S, div_factor
        nc_s_out = S if nc_s_out is None else nc_s_out
        nc_v_out = S if nc_v_out is None else nc_v_out
        self.radial_nn1 = radial_nn(num_out_features=4 * S)
        self.linear1 = SVLinear(2 * S, 2 * S, 2 * S, S, add_bias=True)
        self.radial_nn2 = radial_nn(num_out_features=4 * S)
        self.linear2 = SVLinear(2 * S, 2 * S, 2 * S, S, add_bias=True)
        self.linear3 = SVLinear(S, nc_s_out, S, nc_v_out, add_bias=True)
        self.linear_self = SVLinear(S, nc_s_out, S, nc_v_out, add_bias=False)

    def _gated(self, s_p, v_p, w, linear):
        S = self.S
        s_p, v_p = linear(w[..., : 2 * S] * s_p, w[..., 2 * S :, None] * v_p)
        return F.silu(s_p[..., :S]), torch.sigmoid(s_p[..., S:])[..., None] * v_p

    def forward(self, s, v, pair_mask, r, rvec, weight_cutoff=None, edges=None, ts=None):
        s0, v0 = s, v
        maskf = pair_mask.to(s.dtype)
        r, rvec = _mask_geometry(pair_mask, r, rvec)

        # the product of the node tensors: i = dst (axis 1), j = src (axis 2)
        s1, v1 = s[:, :, None, :], v[:, :, None, :, :]
        s2, v2 = s[:, None, :, :], v[:, None, :, :, :]
        s_p = torch.cat([s1 * s2, (v1 * v2).sum(dim=-1)], dim=-1)  # [G, N, N, 2S]
        v_p = torch.cat([s1[..., None] * v2, v1 * s2[..., None]], dim=-2)  # [G, N, N, 2S, 3]
        s_p, v_p = self._gated(s_p, v_p, self.radial_nn1(r, edges, ts), self.linear1)

        # the product with the edge direction
        rv = rvec[..., None, :]
        s_p, v_p = torch.cat([s_p, (v_p * rv).sum(dim=-1)], dim=-1), torch.cat([s_p[..., None] * rv, v_p], dim=-2)
        s_p, v_p = self._gated(s_p, v_p, self.radial_nn2(r, edges, ts), self.linear2)

        # the masked sum over sources
        s_r = (s_p * maskf[..., None]).sum(dim=2) / self.div_factor
        v_r = (v_p * maskf[..., None, None]).sum(dim=2) / self.div_factor
        s_r, v_r = self.linear3(s_r, v_r)

        # self interaction and the residual
        s0, v0 = self.linear_self(s0, v0)
        s = s0 + s_r if s0 is not None else None
        v = v0 + v_r if v0 is not None else None
        return s, v
