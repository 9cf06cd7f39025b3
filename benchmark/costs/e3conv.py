"""Operations and bytes of the E3Conv forward and of its kernels, counted
from the inputs: the pairs of real atoms inside the cutoff of each frame and
the bonds, never the padded pairs.

The kernels' counts are copies of `chip_smoke.py`'s (`stack_flops_bytes` for
K3, `check_fused_block_tiled`'s for K5), kept here so that a change to the
program cannot change the yardstick. One difference: the operations count
the real atoms where `chip_smoke.py`'s take the padded G N (its batches have
no padding): the padding is no work the inputs need.

A block of the separable (uvu) product on `pairs` visited pairs, input
widths (s_in scalars, v_in vectors) and output widths (Sc scalars, Vg gated
vectors, each gated vector with its gate) costs
  2 pairs (nr 64 + 64 (2 s_in + 3 v_in))                 the radial MLP
  + 2 G N ((s_in + v_in)(Sc + Vg) + 3 (s_in + 2 v_in) Vg  the post-linear
           + Sc^2 + 3 Vg^2 + s_in Sc + 3 v_in Vg)          the block's linears
(nr = 32 radial channels; the bondedness rows fold into the first bias).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "visited_pairs", "separable_block", "stack_launch", "tiled_launch", "separable_forward_flops",
    "uvw_forward_flops", "kernel_widths", "peaks", "roofline_ms",
]

F32, BOOL, I64 = 4, 1, 8
N_RADIAL, RADIAL_HIDDEN = 32, 64


def kernel_widths(S: int, V: int, S_emb: int, out_l0: int = 0, out_l1: int = 1) -> dict:
    """The widths the kernels see for hidden irreps `Sx0e + Vx1e`, an
    embedding of S_emb scalars and outputs of out_l0 scalars and out_l1
    vectors: each block outputs Sc = S scalars and Vg = V gated vectors
    (`ops/cuda/conv_block.BlockWeights`)."""
    return dict(S=S, V=V, S_emb=S_emb, Sc=S, Vg=V, C0o=out_l0, V1o=out_l1)


def visited_pairs(scaled_pos: torch.Tensor, node_mask: torch.Tensor, bond_mask: torch.Tensor,
                  cutoff: float) -> torch.Tensor:
    """[G] int64: ordered pairs of real atoms (no self-pair) closer than the
    cutoff, plus the real directed bonds, on the positions the network sees
    (mean-centred and scaled by c_in) against the scaled cutoff."""
    d = torch.cdist(scaled_pos.to(torch.float32), scaled_pos.to(torch.float32))
    m = node_mask[:, :, None] & node_mask[:, None, :]
    m &= ~torch.eye(node_mask.shape[1], dtype=torch.bool, device=node_mask.device)[None]
    return ((d < cutoff) & m).sum((1, 2)) + bond_mask.sum(-1)


def separable_block(pairs: int, nodes: int, s_in: int, v_in: int, Sc: int, Vg: int) -> int:
    wd = 2 * s_in + 3 * v_in
    return 2 * pairs * (N_RADIAL * RADIAL_HIDDEN + RADIAL_HIDDEN * wd) + 2 * nodes * (
        (s_in + v_in) * (Sc + Vg) + 3 * (s_in + 2 * v_in) * Vg + Sc * Sc + 3 * Vg * Vg
        + s_in * Sc + 3 * v_in * Vg
    )


def _block_weight_bytes(s_in: int, v_in: int, Sc: int, Vg: int, cdt: int) -> int:
    """w1 [nr, 64], w2 [64, 2s+3v], pl0, pl1, lin20, lin21, sk0, sk1 in the
    compute dtype; b1d, b1b [64] and b2 [2s+3v] in f32."""
    wd = 2 * s_in + 3 * v_in
    mats = (N_RADIAL * RADIAL_HIDDEN + RADIAL_HIDDEN * wd + (s_in + v_in) * (Sc + Vg)
            + (s_in + 2 * v_in) * Vg + Sc * Sc + Vg * Vg + s_in * Sc + v_in * Vg)
    return cdt * mats + F32 * (2 * RADIAL_HIDDEN + wd)


def _head(nodes: int, w: dict) -> int:
    S, V = w["S"], w["V"]
    return 2 * nodes * (S * S + S * V + 3 * V * V + S * w["C0o"] + 3 * V * w["V1o"])


def separable_forward_flops(pairs: int, nodes: int, w: dict, layers: int) -> int:
    """The whole forward after the embedding at `pairs` visited pairs and
    `nodes` real atoms: the projector, `layers` hidden blocks and the head."""
    return (separable_block(pairs, nodes, w["S_emb"], 0, w["Sc"], w["Vg"])
            + layers * separable_block(pairs, nodes, w["S"], w["V"], w["Sc"], w["Vg"]) + _head(nodes, w))


def stack_launch(pairs: int, nodes: int, G: int, N: int, B: int, w: dict, layers: int, cdt: int
                 ) -> Tuple[int, int]:
    """(operations, bytes) of one K3 launch on [G, N] padded graphs with
    `nodes` real atoms: every block and the head; the positions, masks,
    bonds, embedding, the layers' noise scales and skip weights, every
    weight and the output, each read or written once."""
    S, V = w["S"], w["V"]
    head_w = cdt * (S * S + S * V + V * V + S * w["C0o"] + V * w["V1o"])
    nbytes = (
        G * N * 3 * F32 + G * N * BOOL + 2 * G * B * I64 + G * B * BOOL + G * N * w["S_emb"] * F32
        + 2 * layers * (S + V) * F32 + G * N * (w["C0o"] + 3 * w["V1o"]) * F32
        + _block_weight_bytes(w["S_emb"], 0, w["Sc"], w["Vg"], cdt)
        + layers * _block_weight_bytes(S, V, w["Sc"], w["Vg"], cdt) + head_w
    )
    return separable_forward_flops(pairs, nodes, w, layers), nbytes


def tiled_launch(pairs: int, nodes: int, G: int, N: int, B: int, s_in: int, v_in: int, w: dict,
                 cdt: int) -> Tuple[int, int]:
    """(operations, bytes) of one K5 launch (one ConvBlock): the block's
    input in the compute dtype, positions, masks, bonds, its weights and its
    f32 output, each once."""
    Sc, Vg = w["Sc"], w["Vg"]
    nbytes = (G * N * (s_in + 3 * v_in) * cdt + G * N * 3 * F32 + G * N * BOOL + 2 * G * B * I64
              + G * B * BOOL + G * N * (Sc + 3 * Vg) * F32 + _block_weight_bytes(s_in, v_in, Sc, Vg, cdt))
    return separable_block(pairs, nodes, s_in, v_in, Sc, Vg), nbytes


def _tp_paths(in_blocks, out_blocks):
    """(m1, l1, l2, m3, l3) for each path of the product of `in_blocks` with
    SH 1x0e + 1x1e into `out_blocks` ((mul, l) pairs; every irrep here is of
    even parity, so l alone decides)."""
    paths = []
    for m1, l1 in in_blocks:
        for l2 in (0, 1):
            for m3, l3 in out_blocks:
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    paths.append((m1, l1, l2, m3, l3))
    return paths


def uvw_forward_flops(pairs: int, nodes: int, S: int, V: int, S_emb: int, layers: int,
                      out_l1: int = 1) -> int:
    """The uvw E3Conv forward at `pairs` visited pairs and `nodes` real
    atoms: per block and pair the radial MLP (64 -> 64 -> the product's
    weights) and the product (for each path the Clebsch-Gordan contraction,
    then the weighted sum over input copies), per atom the block's linears;
    then the head."""
    gate_out = [(S + V, 0), (V, 1)]

    def block(in_blocks):
        paths = _tp_paths(in_blocks, gate_out)
        weights = sum(m1 * m3 for m1, _, _, m3, _ in paths)
        per_pair = 2 * (RADIAL_HIDDEN * RADIAL_HIDDEN + RADIAL_HIDDEN * weights)
        for m1, l1, l2, m3, l3 in paths:
            d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
            per_pair += 2 * m1 * d1 * d2 * d3 + 2 * m1 * m3 * d3
        s_in = sum(m for m, l in in_blocks if l == 0)
        v_in = sum(m for m, l in in_blocks if l == 1)
        per_node = 2 * ((s_in * S + 3 * v_in * V)  # the skip linear
                        + (S * S + 3 * V * V))  # the linear after the gate
        return pairs * per_pair + nodes * per_node

    head = nodes * 2 * (S * (S + V) + 3 * V * V + 3 * V * out_l1)
    return block([(S_emb, 0)]) + layers * block([(S, 0), (V, 1)]) + head


def peaks() -> Dict[str, float]:
    """Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W)."""
    return {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}


def roofline_ms(flops: int, nbytes: int, peak_flops: float) -> float:
    return 1e3 * max(flops / peak_flops, nbytes / peaks()["hbm_bytes"])

