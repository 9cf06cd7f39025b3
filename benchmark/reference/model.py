"""The plain reference of JAMUN's E3Conv denoiser network: a frozen copy of
the port's plain PyTorch path (`jamun_tpu_torch/models/e3conv.py` with
`use_pallas=False`, `ops/conv.py`, `ops/tensor_product.py`, `ops/mlp.py`,
`ops/linear.py`, `ops/gate.py`, `ops/sh.py`, `ops/radial.py`,
`ops/graph.dense_edge_data`, `models/embeddings.py`,
`models/noise_conditioning.py`), cut to what the benchmark's two
configurations use: the dense edge set, SH `1x0e + 1x1e`, and the uvu
(depthwise) or uvw (fully connected) product.

It computes in float32 (`precision.Precision` rounds the operands of every
product for the controls). Both products run e3nn's generic weighted tensor
product, so the uvu messages here do not share the closed form that the
program and its kernels compute. Parameter names are the port's, so one
state dict, made by the benchmark, loads into both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.cg import real_wigner_3j
from benchmark.reference.precision import F32, Precision

__all__ = ["Irreps", "E3Conv", "irreps_to_vector"]


# ---- irreps: "120x0e + 32x1e" as a tuple of (mul, l, parity) ----


@dataclasses.dataclass(frozen=True)
class Irrep:
    l: int
    p: int

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __mul__(self, other: "Irrep") -> List["Irrep"]:
        return [Irrep(l, self.p * other.p) for l in range(abs(self.l - other.l), self.l + other.l + 1)]


class Irreps(tuple):
    def __new__(cls, irreps):
        if isinstance(irreps, Irreps):
            return super().__new__(cls, irreps)
        out = []
        if isinstance(irreps, str):
            for term in irreps.split("+"):
                mul, ir = term.strip().split("x")
                out.append((int(mul), Irrep(int(ir[:-1]), 1 if ir[-1] == "e" else -1)))
        else:
            out = [(int(m), ir) for m, ir in irreps]
        return super().__new__(cls, out)

    @property
    def dim(self) -> int:
        return sum(m * ir.dim for m, ir in self)

    @property
    def num_irreps(self) -> int:
        return sum(m for m, _ in self)

    def slices(self) -> List[slice]:
        out, ix = [], 0
        for m, ir in self:
            out.append(slice(ix, ix + m * ir.dim))
            ix += m * ir.dim
        return out

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def has(self, ir: Irrep) -> bool:
        return any(i == ir for _, i in self)

    def simplify(self) -> "Irreps":
        out = []
        for m, ir in self:
            if out and out[-1][1] == ir:
                out[-1] = (out[-1][0] + m, ir)
            elif m > 0:
                out.append((m, ir))
        return Irreps(out)


SCALAR = Irrep(0, 1)


def scale_irreps(x: torch.Tensor, scales: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    """Each irrep copy of x times its scalar in `scales` [..., num_irreps]."""
    parts, ix = [], 0
    for m, ir in irreps:
        s = scales[..., ix: ix + m]
        parts.append(s.repeat_interleave(ir.dim, dim=-1) if ir.dim > 1 else s)
        ix += m
    return x * torch.cat(parts, dim=-1)


def irreps_to_vector(f: torch.Tensor) -> torch.Tensor:
    """The l = 1 component order (y, z, x) -> (x, y, z)."""
    return torch.cat([f[..., 2:3], f[..., 0:2]], dim=-1)


def spherical_harmonics(v: torch.Tensor) -> torch.Tensor:
    """SH `1x0e + 1x1e`, component normalization: [1, sqrt(3) (y, z, x) / |v|]."""
    n = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    y1 = math.sqrt(3.0) * torch.cat([n[..., 1:3], n[..., 0:1]], dim=-1)
    return torch.cat([torch.ones_like(y1[..., :1]), y1], dim=-1)


def soft_one_hot_linspace(x: torch.Tensor, end: float, number: int) -> torch.Tensor:
    """e3nn's Gaussian basis on (0, end) with the cutoff: n centres at
    k end / (n + 1), width one step, divided by 1.12."""
    i = torch.arange(1, number + 1, dtype=x.dtype, device=x.device)
    step = end / (number + 1)
    diff = (x[..., None] - end * i / (number + 1)) / step
    return torch.exp(-(diff**2)) / 1.12


# ---- layers ----


class Dense(nn.Module):
    """x @ kernel + bias, kernel [in, out]."""

    def __init__(self, n_in: int, n_out: int, prec: Precision):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.empty(n_out))
        self.prec = prec

    def forward(self, x: torch.Tensor, cols: slice = slice(None)) -> torch.Tensor:
        q = self.prec.q
        return q(x) @ q(self.kernel[:, cols]) + self.bias[cols]


class ScalarMLP(nn.Module):
    """Dense -> SiLU -> Dense, the radial network."""

    def __init__(self, n_in: int, n_out: int, hidden: int, prec: Precision):
        super().__init__()
        self.Dense_0 = Dense(n_in, hidden, prec)
        self.Dense_1 = Dense(hidden, n_out, prec)

    def split_forward(self, x: torch.Tensor, slices: List[slice]) -> List[torch.Tensor]:
        """The output's columns at each slice, one tensor each."""
        h = F.silu(self.Dense_0(x))
        return [self.Dense_1(h, s) for s in slices]


class IrrepsLinear(nn.Module):
    """e3nn's o3.Linear: each output block sums the input blocks of its irrep
    through a [mul_in, mul_out] kernel `w_{i_in}_{i_out}`, over
    sqrt(the summed input multiplicity)."""

    def __init__(self, irreps_in, irreps_out, prec: Precision):
        super().__init__()
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        self.prec = prec
        self.paths = []
        for i_out, (m_out, ir_out) in enumerate(self.irreps_out):
            for i_in, (m_in, ir_in) in enumerate(self.irreps_in):
                if ir_in == ir_out:
                    self.paths.append((i_in, i_out))
                    self.register_parameter(f"w_{i_in}_{i_out}", nn.Parameter(torch.empty(m_in, m_out)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.prec.q
        batch = x.shape[:-1]
        sl = self.irreps_in.slices()
        blocks = []
        for i_out, (m_out, ir_out) in enumerate(self.irreps_out):
            acc, fan = None, 0
            for i_in, (m_in, ir_in) in enumerate(self.irreps_in):
                if ir_in != ir_out:
                    continue
                f = x[..., sl[i_in]].reshape(batch + (m_in, ir_in.dim))
                blk = torch.einsum("...ui,uw->...wi", q(f), q(getattr(self, f"w_{i_in}_{i_out}")))
                acc = blk if acc is None else acc + blk
                fan += m_in
            if acc is None:
                acc = x.new_zeros(batch + (m_out, ir_out.dim))
            else:
                acc = acc / math.sqrt(max(fan, 1))
            blocks.append(acc.reshape(batch + (m_out * ir_out.dim,)))
        return torch.cat(blocks, dim=-1)


class Gate:
    """scalars ++ gates ++ gated -> LeakyReLU(0.01) on even scalars, the gated
    l > 0 copies times sigmoid(gate)."""

    def __init__(self, irreps_out):
        irreps_out = Irreps(irreps_out)
        self.scalars = Irreps([(m, ir) for m, ir in irreps_out if ir.l == 0])
        self.gated = Irreps([(m, ir) for m, ir in irreps_out if ir.l > 0])
        self.gates = Irreps([(m, SCALAR) for m, _ in self.gated])
        self.irreps_in = self.scalars + self.gates + self.gated
        self.irreps_out = (self.scalars + self.gated).simplify()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ds, dg = self.scalars.dim, self.gates.dim
        out = [F.leaky_relu(x[..., :ds], 0.01)]
        if dg:
            out.append(scale_irreps(x[..., ds + dg:], torch.sigmoid(x[..., ds: ds + dg]), self.gated))
        return torch.cat(out, dim=-1)


class TensorProduct:
    """e3nn's weighted tensor product with external per-pair weights, in
    "uvw" (fully connected) or "uvu" (depthwise) mode, component
    normalization and element path normalization."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out, instructions, prec: Precision):
        self.in1, self.in2, self.out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
        self.prec = prec
        fan = [0] * len(self.out)
        for i1, i2, i3, mode in instructions:
            fan[i3] += self.in1[i1][0] * self.in2[i2][0] if mode == "uvw" else self.in2[i2][0]
        self.paths, offset = [], 0
        for i1, i2, i3, mode in instructions:
            m1, m2, m3 = self.in1[i1][0], self.in2[i2][0], self.out[i3][0]
            shape = (m1, m2, m3) if mode == "uvw" else (m1, m2)
            n = int(np.prod(shape))
            self.paths.append((i1, i2, i3, mode, math.sqrt(1.0 / fan[i3]), slice(offset, offset + n), shape))
            offset += n
        self.weight_numel = offset
        self._cg: Dict[tuple, torch.Tensor] = {}

    def slices(self) -> List[slice]:
        return [p[5] for p in self.paths]

    def _coupling(self, l1, l2, l3, like: torch.Tensor) -> torch.Tensor:
        key = (l1, l2, l3, like.device)
        if key not in self._cg:
            c = real_wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
            self._cg[key] = torch.as_tensor(c, dtype=torch.float32, device=like.device)
        return self._cg[key]

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor, weights: List[torch.Tensor]) -> torch.Tensor:
        q = self.prec.q
        batch = x1.shape[:-1]
        s1, s2 = self.in1.slices(), self.in2.slices()
        blocks = [None] * len(self.out)
        for (i1, i2, i3, mode, pw, _, shape), w in zip(self.paths, weights):
            (m1, ir1), (m2, ir2), (_, ir3) = self.in1[i1], self.in2[i2], self.out[i3]
            f1 = x1[..., s1[i1]].reshape(batch + (m1, ir1.dim))
            f2 = x2[..., s2[i2]].reshape(batch + (m2, ir2.dim))
            t = torch.einsum("...ui,...vj,ijk->...uvk", q(f1), q(f2), self._coupling(ir1.l, ir2.l, ir3.l, x1))
            w = q(w.reshape(w.shape[:-1] + shape))
            if mode == "uvw":
                blk = torch.einsum("...uvk,...uvw->...wk", q(t), w)
            else:
                blk = torch.einsum("...uvk,...uv->...uk", q(t), w)
            blk = pw * blk
            blocks[i3] = blk if blocks[i3] is None else blocks[i3] + blk
        return torch.cat([
            x1.new_zeros(batch + (m * ir.dim,)) if b is None else b.reshape(batch + (m * ir.dim,))
            for (m, ir), b in zip(self.out, blocks)
        ], dim=-1)


def fully_connected_tp(irreps_in1, irreps_in2, irreps_out, prec: Precision) -> TensorProduct:
    in1, in2, out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
    ins = [
        (i1, i2, i3, "uvw")
        for i1, (_, a) in enumerate(in1) for i2, (_, b) in enumerate(in2) for i3, (_, c) in enumerate(out)
        if c in a * b
    ]
    return TensorProduct(in1, in2, out, ins, prec)


def depthwise_tp(irreps_in1, irreps_in2, irreps_out, prec: Precision) -> Tuple[TensorProduct, Irreps]:
    """The depthwise product and its output irreps: every allowed product
    whose irrep is in irreps_out or an even scalar, in path order."""
    in1, in2, out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
    blocks, ins = [], []
    for i1, (m1, a) in enumerate(in1):
        for i2, (_, b) in enumerate(in2):
            for c in a * b:
                if out.has(c) or c == SCALAR:
                    ins.append((i1, i2, len(blocks), "uvu"))
                    blocks.append((m1, c))
    dtp = Irreps(blocks)
    return TensorProduct(in1, in2, dtp, ins, prec), dtp


@dataclasses.dataclass
class Edges:
    """One forward's edge features: every ordered pair of real atoms inside
    the cutoff (dense, masked by `adj`), and the bonds as a second edge set."""

    sh: torch.Tensor  # [G, N(dst), N(src), 4]
    attr: torch.Tensor  # [G, N, N, edge_attr_dim]
    adj: torch.Tensor  # [G, N, N] f32
    sh_bond: torch.Tensor  # [G, B, 4]
    attr_bond: torch.Tensor  # [G, B, edge_attr_dim]
    bond_src: torch.Tensor
    bond_dst: torch.Tensor
    bond_mask: torch.Tensor  # [G, B] f32


class Conv(nn.Module):
    """Tensor-field-network convolution: the product of the source features,
    the edge SH and the radial MLP's per-pair weights, summed over the pairs
    and the bonds into each atom and divided by their count; the depthwise
    product is followed by its post-linear."""

    def __init__(self, irreps_in, irreps_out, edge_attr_dim: int, tensor_product: str, prec: Precision):
        super().__init__()
        sh = Irreps("1x0e + 1x1e")
        post = None
        if tensor_product == "uvw":
            self.tp = fully_connected_tp(irreps_in, sh, irreps_out, prec)
        elif tensor_product == "uvu":
            self.tp, dtp = depthwise_tp(irreps_in, sh, irreps_out, prec)
            post = IrrepsLinear(dtp, irreps_out, prec)
        else:
            raise ValueError(f"tensor_product={tensor_product!r}")
        self.radial_nn = ScalarMLP(edge_attr_dim, self.tp.weight_numel, edge_attr_dim, prec)
        self._post_linear = post

    def forward(self, x: torch.Tensor, e: Edges) -> torch.Tensor:
        G, N, D = x.shape
        w = self.radial_nn.split_forward(e.attr, self.tp.slices())
        msg = self.tp(x[:, None].expand(G, N, N, D), e.sh, w)
        out = torch.einsum("gijd,gij->gid", msg, e.adj)
        deg = e.adj.sum(-1)
        src_b = torch.gather(x, 1, e.bond_src[..., None].expand(-1, -1, D))
        msg_b = self.tp(src_b, e.sh_bond, self.radial_nn.split_forward(e.attr_bond, self.tp.slices()))
        msg_b = msg_b * e.bond_mask[..., None]
        out = out.scatter_add(1, e.bond_dst[..., None].expand(-1, -1, msg_b.shape[-1]), msg_b)
        deg = deg.scatter_add(1, e.bond_dst, e.bond_mask)
        out = out / torch.clamp(deg, min=1.0)[..., None]
        return out if self._post_linear is None else self._post_linear(out)


class ConvBlock(nn.Module):
    """IrrepsLinear_1(gate(Conv_0(x))) + IrrepsLinear_0(x)."""

    def __init__(self, irreps_in, irreps_out, edge_attr_dim, tensor_product, prec):
        super().__init__()
        self.gate = Gate(irreps_out)
        self.Conv_0 = Conv(irreps_in, self.gate.irreps_in, edge_attr_dim, tensor_product, prec)
        self.IrrepsLinear_0 = IrrepsLinear(irreps_in, self.gate.irreps_out, prec)
        self.IrrepsLinear_1 = IrrepsLinear(self.gate.irreps_out, self.gate.irreps_out, prec)

    def forward(self, x: torch.Tensor, e: Edges) -> torch.Tensor:
        return self.IrrepsLinear_1(self.gate(self.Conv_0(x, e))) + self.IrrepsLinear_0(x)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        return self.embedding[index]


class AtomEmbeddingWithResidueInformation(nn.Module):
    """Atom type, atom code, residue code and residue index embeddings side by
    side; the residue index is zeroed (use_residue_sequence_index false)."""

    def __init__(self, dims: Tuple[int, int, int, int]):
        super().__init__()
        self.Embed_0 = Embed(20, dims[0])
        self.Embed_1 = Embed(10, dims[1])
        self.Embed_2 = Embed(25, dims[2])
        self.Embed_3 = Embed(10, dims[3])

    def forward(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([
            self.Embed_0(b["atom_type_index"]), self.Embed_1(b["atom_code_index"]),
            self.Embed_2(b["residue_code_index"]),
            self.Embed_3(torch.zeros_like(b["residue_sequence_index"])),
        ], dim=-1)


class _ScalePredictor(nn.Module):
    """Dense(1 -> n) -> SELU -> Dense(n -> n) of c_noise."""

    def __init__(self, n: int, prec: Precision):
        super().__init__()
        self.Dense_0 = Dense(1, n, prec)
        self.Dense_1 = Dense(n, n, prec)

    def forward(self, c_noise: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.selu(self.Dense_0(c_noise.reshape(-1, 1))))[0]


class NoiseConditionalScaling(nn.Module):
    def __init__(self, irreps, prec):
        super().__init__()
        self.irreps = Irreps(irreps)
        self._ScalePredictor_0 = _ScalePredictor(self.irreps.num_irreps, prec)

    def forward(self, x, c_noise):
        return scale_irreps(x, self._ScalePredictor_0(c_noise), self.irreps)


class NoiseConditionalSkipConnection(nn.Module):
    def __init__(self, irreps, prec):
        super().__init__()
        self.irreps = Irreps(irreps)
        self._ScalePredictor_0 = _ScalePredictor(self.irreps.num_irreps, prec)

    def forward(self, x1, x2, c_noise):
        w = torch.sigmoid(self._ScalePredictor_0(c_noise))
        return scale_irreps(x1, w, self.irreps) + scale_irreps(x2, 1.0 - w, self.irreps)


class _HiddenLayer(nn.Module):
    def __init__(self, irreps, edge_attr_dim, tensor_product, prec):
        super().__init__()
        self.NoiseConditionalScaling_0 = NoiseConditionalScaling(irreps, prec)
        self.ConvBlock_0 = ConvBlock(irreps, irreps, edge_attr_dim, tensor_product, prec)
        self.NoiseConditionalSkipConnection_0 = NoiseConditionalSkipConnection(irreps, prec)

    def forward(self, x, c_noise, e):
        out = self.ConvBlock_0(self.NoiseConditionalScaling_0(x, c_noise), e)
        return self.NoiseConditionalSkipConnection_0(x, out, c_noise)


class EquivariantMLPBlock(nn.Module):
    def __init__(self, irreps_in, irreps_out, prec):
        super().__init__()
        self.gate = Gate(irreps_out)
        self.IrrepsLinear_0 = IrrepsLinear(irreps_in, self.gate.irreps_in, prec)

    def forward(self, x):
        return self.gate(self.IrrepsLinear_0(x))


class EquivariantMLP(nn.Module):
    def __init__(self, irreps_in, irreps_out, prec):
        super().__init__()
        self.EquivariantMLPBlock_0 = EquivariantMLPBlock(irreps_in, irreps_in, prec)
        self.IrrepsLinear_0 = IrrepsLinear(self.EquivariantMLPBlock_0.gate.irreps_out, irreps_out, prec)

    def forward(self, x):
        return self.IrrepsLinear_0(self.EquivariantMLPBlock_0(x))


class E3Conv(nn.Module):
    """JAMUN's E3Conv: atom embedding, a noise-scaled projector ConvBlock,
    `n_layers` hidden layers (noise scaling, ConvBlock, noise-conditional
    skip), the gated head, times `output_gain` on real atoms. Takes the
    arch fields of the configuration file that describe the network; the
    kernel switches (`use_pallas`, `dtype`) are the program's, not the
    model's."""

    def __init__(self, arch: dict, prec: Precision = F32):
        super().__init__()
        if arch.get("irreps_sh", "1x0e + 1x1e").replace(" ", "") != "1x0e+1x1e":
            raise ValueError("the reference covers SH 1x0e + 1x1e")
        if not arch.get("use_residue_information", True) or arch.get("use_residue_sequence_index", False):
            raise ValueError("the reference covers the residue embedding without the sequence index")
        hidden, tp = Irreps(arch["irreps_hidden"]), arch["tensor_product"]
        A = arch["edge_attr_dim"]
        self.bonded_dim, self.radial_dim = A // 2, (A + 1) // 2
        self.n_layers = arch["n_layers"]
        dims = (arch["atom_type_embedding_dim"], arch["atom_code_embedding_dim"],
                arch["residue_code_embedding_dim"], arch["residue_index_embedding_dim"])
        node = Irreps([(sum(dims), SCALAR)])
        self.embed_bondedness = nn.Parameter(torch.empty(2, self.bonded_dim))
        self.AtomEmbeddingWithResidueInformation_0 = AtomEmbeddingWithResidueInformation(dims)
        self.NoiseConditionalScaling_0 = NoiseConditionalScaling(node, prec)
        self.ConvBlock_0 = ConvBlock(node, hidden, A, tp, prec)
        for k in range(self.n_layers):
            self.add_module(f"_HiddenLayer_{k}", _HiddenLayer(hidden, A, tp, prec))
        self.EquivariantMLP_0 = EquivariantMLP(hidden, Irreps(arch["irreps_out"]), prec)
        self.output_gain = nn.Parameter(torch.empty(()))

    def edges(self, b: Dict[str, torch.Tensor], pos: torch.Tensor, cutoff: float) -> Edges:
        mask = b["node_mask"]
        vec = pos[:, None, :, :] - pos[:, :, None, :]  # [g, dst, src]
        dist = torch.linalg.vector_norm(vec + 1e-12, dim=-1)
        eye = torch.eye(pos.shape[1], dtype=torch.bool, device=pos.device)[None]
        adj = ((dist < cutoff) & mask[:, :, None] & mask[:, None, :] & ~eye).to(pos.dtype)
        src = torch.gather(pos, 1, b["bond_src"][..., None].expand(-1, -1, 3))
        dst = torch.gather(pos, 1, b["bond_dst"][..., None].expand(-1, -1, 3))
        bvec = src - dst

        def attr(d, bonded: int):
            bond = self.embed_bondedness[bonded].expand(d.shape + (self.bonded_dim,))
            return torch.cat([bond, soft_one_hot_linspace(d, cutoff, self.radial_dim)], dim=-1)

        return Edges(
            sh=spherical_harmonics(vec), attr=attr(dist, 0), adj=adj,
            sh_bond=spherical_harmonics(bvec),
            attr_bond=attr(torch.linalg.vector_norm(bvec + 1e-12, dim=-1), 1),
            bond_src=b["bond_src"], bond_dst=b["bond_dst"], bond_mask=b["bond_mask"].to(pos.dtype),
        )

    def forward(self, b: Dict[str, torch.Tensor], pos: torch.Tensor, c_noise: torch.Tensor, cutoff: float):
        """pos [G, N, 3] the scaled noisy positions, c_noise [1] -> [G, N, 3]
        (irreps order y, z, x)."""
        e = self.edges(b, pos, cutoff)
        x = self.NoiseConditionalScaling_0(self.AtomEmbeddingWithResidueInformation_0(b), c_noise)
        x = self.ConvBlock_0(x, e)
        for k in range(self.n_layers):
            x = getattr(self, f"_HiddenLayer_{k}")(x, c_noise, e)
        x = self.EquivariantMLP_0(x)
        return x * self.output_gain * b["node_mask"][..., None].to(x.dtype)
