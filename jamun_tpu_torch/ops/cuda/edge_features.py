"""K1: per-forward edge features of the dense E3Conv (wrapper + plain twin).

Replaces `packed_edge_features` of `jamun_tpu/ops/pallas/packed_conv.py`
(pallas_call at line 806). The CUDA kernel is `csrc/edge_features.cu`: a
CTA of 256 threads owns a tile of at most 256 edges of one graph (whole
destination rows, or one row's chunk), stages the rows in shared memory and
writes them out as one contiguous run; `layout` mirrors its launch shape.

Outputs, in the compute dtype (EC = 4 + n_radial channels per edge):
    ef [G, N, N, EC]: dense pair src j -> dst i, vector pos[j] - pos[i]
    bf [G, B, EC]:    bond b, vector pos[src] - pos[dst]
with channels [shy, shz, shx, adj (or bond mask), radial basis...].
`packed_rows` lays them out as the TPU kernel's [G, 16 + pad16(nr), P] rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from jamun_tpu_torch.ops.cuda.build import CudaKernel

__all__ = [
    "edge_features", "edge_features_plain", "pair_features_plain", "bond_features_plain",
    "packed_rows", "layout", "occupancy", "check_limits", "tiling", "staged_bytes", "KERNEL",
    "EF_GEOM",
    "MAX_ELEMENTS",
]

EF_GEOM = 4  # channels before the radial basis: shy, shz, shx, adj
_SQRT3 = math.sqrt(3.0)
# the kernel's 32-bit offsets: ef and bf together hold at most this many elements
MAX_ELEMENTS = 0x7FFFFFFF - 65536 * 256
THREADS = 256  # per CTA; a tile holds at most one edge per thread
STAGE_BYTES = 36864  # staged rows per CTA at most, K1 and K7: 256 f32 rows of EC = 36
_LIMITS = "ROADMAP.md queue A, 'Edge features at sizes no configuration reaches'"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P]
KERNEL = CudaKernel("edge_features", {
    "edge_features_f32": _ARGS, "edge_features_bf16": _ARGS,
    "edge_features_occupancy": [_I] * 5 + [_P],
})
_ENTRY = {torch.float32: "edge_features_f32", torch.bfloat16: "edge_features_bf16"}
ESZ = {torch.float32: 4, torch.bfloat16: 2}  # bytes per stored value
_OCCUPANCY = ("threads", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm", "edges_per_tile",
              "rows_per_tile", "ctas")


def tiling(rows: int, length: int, edges: int) -> Tuple[int, int, int, int]:
    """How one graph's [rows, length] edges split into tiles of at most
    `edges` (the mirror of the kernels' `tiling`): (rows and columns per
    tile, chunks per row, tiles per graph). Whole rows where a row fits,
    else chunks of one row."""
    if rows == 0 or length == 0 or edges < 1:
        return 0, 0, 1, 0
    if length <= edges:
        r = edges // length
        return r, length, 1, -(-rows // r)
    chunks = -(-length // edges)
    return 1, edges, chunks, rows * chunks


def staged_bytes(cap: int, channels: int, esz: int) -> int:
    """Shared bytes of a CTA whose largest tile holds `cap` rows of
    `channels` values: the rows (16 bytes more for the shift that aligns
    them with their output) and a f32 distance per row."""
    return (cap * channels * esz + 31) // 16 * 16 + cap * 4


def layout(G: int, N: int, B: int, n_radial: int = 32, cdt=torch.bfloat16) -> dict:
    """How K1 is launched at these sizes (the mirror of `make_params`):
    threads and shared bytes per CTA, edges in the largest tile, rows of
    pairs per tile, CTAs (the dense pairs' tiles, then the bonds')."""
    ec, esz = EF_GEOM + n_radial, ESZ[cdt]
    edges = min(THREADS, STAGE_BYTES // (ec * esz))
    dense, bonds = tiling(N, N, edges), tiling(1, B, edges)
    cap = max(min(dense[0], N) * dense[1], min(bonds[0], 1) * bonds[1])
    return dict(threads=THREADS, smem_bytes=staged_bytes(cap, ec, esz),
                edges_per_tile=cap, rows_per_tile=dense[0], ctas=G * (dense[3] + bonds[3]))


def check_limits(G: int, N: int, B: int, n_radial: int, cdt) -> None:
    """Raise NotImplementedError for a shape the kernel does not take: more
    than MAX_ELEMENTS values in ef and bf (its 32-bit offsets), or an edge
    row wider than a CTA's staging buffer."""
    ec = EF_GEOM + n_radial
    total = G * (N * N + B) * ec
    if total > MAX_ELEMENTS or ec * ESZ[cdt] > STAGE_BYTES:
        raise NotImplementedError(
            f"edge_features: {total} elements (max {MAX_ELEMENTS}: 32-bit offsets) or "
            f"{n_radial} radial channels (a {ec}-channel row must fit {STAGE_BYTES} staged "
            f"bytes); see {_LIMITS}"
        )


def occupancy(G: int, N: int, B: int, n_radial: int = 32, cdt=torch.bfloat16) -> dict:
    """`layout` as the library reckons it, with what the current card makes
    of the build: registers and local (spill) bytes per thread, CTAs
    resident per SM."""
    out = (ctypes.c_int * len(_OCCUPANCY))()
    err = KERNEL.fn("edge_features_occupancy")(int(cdt == torch.bfloat16), G, N, B, n_radial,
                                                ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"edge_features.edge_features_occupancy failed with CUDA error {err}")
    return dict(zip(_OCCUPANCY, out))


def _features(dx, dy, dz, flag, cutoff: float, n_radial: int, cdt) -> torch.Tensor:
    """[..., EC] rows of `_geom_radial_rows` from f32 components."""
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    inv_d = 1.0 / torch.clamp(dist, min=1e-12)
    step = torch.tensor(cutoff, dtype=torch.float32, device=dx.device) / (n_radial + 1)
    centers = torch.arange(1, n_radial + 1, dtype=torch.float32, device=dx.device) * step
    diff = (dist[..., None] - centers) / step
    radial = torch.exp(-(diff * diff)) * (1.0 / 1.12)
    sh = torch.stack([_SQRT3 * dy * inv_d, _SQRT3 * dz * inv_d, _SQRT3 * dx * inv_d], dim=-1)
    return torch.cat([sh, flag[..., None], radial], dim=-1).to(cdt)


def bond_features_plain(pos, bond_src, bond_dst, bond_mask, cutoff: float, n_radial: int, cdt):
    """bf [G, B, EC] of the bonds alone (pos f32, cutoff already rounded to
    f32): also what the tiled kernel (`ops/cuda/fused_block_tiled`) rebuilds
    per bond, and `packed_geometry_inputs`' bf."""
    src = torch.gather(pos, 1, bond_src[..., None].expand(-1, -1, 3))
    dst = torch.gather(pos, 1, bond_dst[..., None].expand(-1, -1, 3))
    bx, by, bz = (src - dst).unbind(-1)
    return _features(bx, by, bz, bond_mask.to(torch.float32), cutoff, n_radial, cdt)


def pair_features_plain(pos, node_mask, cutoff: float, n_radial: int, cdt) -> torch.Tensor:
    """ef [G, N, N, EC] of the dense pairs alone (pos f32, cutoff already
    rounded to f32): also what the kernels that rebuild the pair geometry
    from the positions (K5, K8, K9) compute per visited pair."""
    N = pos.shape[1]
    rel = pos[:, None, :, :] - pos[:, :, None, :]  # [g, i, j] = pos_j - pos_i
    dx, dy, dz = rel.unbind(-1)
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)[None]
    adj = (dist < cutoff) & node_mask[:, :, None] & node_mask[:, None, :] & ~eye
    return _features(dx, dy, dz, adj.to(torch.float32), cutoff, n_radial, cdt)


def edge_features_plain(
    pos, node_mask, bond_src, bond_dst, bond_mask, cutoff: float, n_radial: int, cdt
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel (same function, same layout).
    The cutoff is rounded to f32 first, as the kernel receives it."""
    cutoff = float(torch.tensor(cutoff, dtype=torch.float32))
    pos = pos.to(torch.float32)
    ef = pair_features_plain(pos, node_mask, cutoff, n_radial, cdt)
    return ef, bond_features_plain(pos, bond_src, bond_dst, bond_mask, cutoff, n_radial, cdt)


def edge_features(
    pos: torch.Tensor,
    node_mask: torch.Tensor,
    bond_src: torch.Tensor,
    bond_dst: torch.Tensor,
    bond_mask: torch.Tensor,
    cutoff: float,
    n_radial: int = 32,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ef [G, N, N, 4 + n_radial], bf [G, B, 4 + n_radial]) in compute_dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel.

    The features carry no gradient to the positions: a position that
    requires one raises (on both devices), as `packed_edge_features` refuses
    dL/dpos, rather than dropping it silently."""
    if pos.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "edge_features: no gradient with respect to the positions (the kernel path "
            "trains the weights only); detach pos or run the plain path "
            "(ROADMAP.md queue A, 'Position gradients through the kernels')"
        )
    cutoff = float(cutoff)
    if pos.device.type == "cpu":
        return edge_features_plain(
            pos, node_mask, bond_src, bond_dst, bond_mask, cutoff, n_radial, compute_dtype
        )
    if pos.device.type != "cuda":
        raise ValueError(f"edge_features: unsupported device {pos.device}")
    if compute_dtype not in _ENTRY:
        raise TypeError(f"edge_features: compute dtype {compute_dtype} not supported")
    G, N, _ = pos.shape
    B = bond_src.shape[1]
    checks = [
        (pos, torch.float32, (G, N, 3)),
        (node_mask, torch.bool, (G, N)),
        (bond_src, torch.int64, (G, B)),
        (bond_dst, torch.int64, (G, B)),
        (bond_mask, torch.bool, (G, B)),
    ]
    for t, dt, shape in checks:
        if t.device != pos.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"edge_features: want {dt} {shape} contiguous on {pos.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    check_limits(G, N, B, n_radial, compute_dtype)
    ec = EF_GEOM + n_radial
    ef = torch.empty((G, N, N, ec), dtype=compute_dtype, device=pos.device)
    bf = torch.empty((G, B, ec), dtype=compute_dtype, device=pos.device)
    KERNEL.launch(
        _ENTRY[compute_dtype],
        pos.data_ptr(), node_mask.data_ptr(), bond_src.data_ptr(), bond_dst.data_ptr(),
        bond_mask.data_ptr(), cutoff, ef.data_ptr(), bf.data_ptr(), G, N, B, n_radial,
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    return ef, bf


def packed_rows(ef: torch.Tensor, bf: torch.Tensor, n_radial: int):
    """The TPU kernel's layout: ef [G, EFR, N*N] (pair p = i*N + j) and
    bf [G, EFR, B], rows 0-3 sh/adj, rows 16.. the radial basis, zero pads."""
    pad16 = lambda c: ((c + 15) // 16) * 16  # noqa: E731
    efr = 16 + pad16(n_radial)

    def rows(a):
        lead = a.shape[:-1]
        out = a.new_zeros(lead + (efr,))
        out[..., 0:4] = a[..., 0:4]
        out[..., 16 : 16 + n_radial] = a[..., 4:]
        return out

    G, N = ef.shape[0], ef.shape[1]
    return rows(ef).reshape(G, N * N, efr).transpose(1, 2), rows(bf).transpose(1, 2)
