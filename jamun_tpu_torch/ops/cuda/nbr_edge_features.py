"""K7: the sparse path's per-forward edge features from a Verlet-cached
neighbour list (wrapper + plain twin).

Replaces `nbr_edge_features` of `jamun_tpu/ops/pallas/nbr_conv.py`
(pallas_call at line 559), which the JAX model runs once per forward on a
cached list when `JAMUN_NBR_GEOM_KERNEL=1`; the port's switch is
`E3Conv(nbr_geom_kernel=True)`. The CUDA kernel is
`csrc/nbr_edge_features.cu`: a CTA of 256 threads owns a tile of at most 256
slots of one graph (whole destination rows of K slots, or one row's chunk),
stages the radial rows in shared memory and writes them out as one
contiguous run; `layout` mirrors its launch shape.

Inputs: scaled positions pos [G, N, 3] f32, the cached list
nbr_idx [G, N, K] int64 and its superset flags [G, N, K] bool (built within
cutoff + skin), the true cutoff. Outputs: sh [G, N, K, 4] (channel 0 zero,
then sqrt(3) (y, z, x) / dist) and the radial basis [G, N, K, n_radial] in
the compute dtype, the true-cutoff mask [G, N, K] f32 and the indices
[G, N, K] int64 with the masked slots folded to N. The radial values are the
radial half of the edge attributes: `Conv` folds the constant bondedness-0
block into the first radial bias.
"""

from __future__ import annotations

import ctypes

import torch

from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.ops.cuda.edge_features import (
    ESZ, STAGE_BYTES, THREADS, _features, staged_bytes, tiling,
)
from jamun_tpu_torch.ops.neighbors import gather_neighbors

__all__ = [
    "nbr_edge_features", "nbr_edge_features_plain", "layout", "occupancy", "check_limits", "KERNEL",
]

_LIMITS = "ROADMAP.md queue A, 'Edge features at sizes no configuration reaches'"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _P]
KERNEL = CudaKernel("nbr_edge_features", {
    "nbr_edge_features_f32": _ARGS, "nbr_edge_features_bf16": _ARGS,
    "nbr_edge_features_occupancy": [_I] * 5 + [_P],
})
_ENTRY = {torch.float32: "nbr_edge_features_f32", torch.bfloat16: "nbr_edge_features_bf16"}
_OCCUPANCY = ("threads", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm", "slots_per_tile",
              "rows_per_tile", "ctas")


def layout(G: int, N: int, K: int, n_radial: int = 32, cdt=torch.bfloat16) -> dict:
    """How K7 is launched at these sizes (the mirror of `make_params`):
    threads and shared bytes per CTA, slots in the largest tile,
    destination rows per tile, CTAs."""
    esz = ESZ[cdt]
    rows, cols, _, per_graph = tiling(N, K, min(THREADS, STAGE_BYTES // (n_radial * esz)))
    cap = min(rows, N) * cols
    return dict(threads=THREADS, smem_bytes=staged_bytes(cap, n_radial, esz), slots_per_tile=cap,
                rows_per_tile=rows, ctas=G * per_graph)


def check_limits(G: int, N: int, K: int, n_radial: int, cdt) -> None:
    """Raise NotImplementedError for a shape the kernel does not take: a
    radial row wider than a CTA's staging buffer, or more CTAs than a grid
    holds."""
    if n_radial * ESZ[cdt] > STAGE_BYTES or layout(G, N, K, n_radial, cdt)["ctas"] > 0x7FFFFFFF:
        raise NotImplementedError(
            f"nbr_edge_features: {n_radial} radial channels (a row must fit {STAGE_BYTES} staged "
            f"bytes) or G={G}, N={N}, K={K} (at most 2^31 - 1 CTAs); see {_LIMITS}"
        )


def occupancy(G: int, N: int, K: int, n_radial: int = 32, cdt=torch.bfloat16) -> dict:
    """`layout` as the library reckons it, with what the current card makes
    of the build: registers and local (spill) bytes per thread, CTAs
    resident per SM."""
    out = (ctypes.c_int * len(_OCCUPANCY))()
    err = KERNEL.fn("nbr_edge_features_occupancy")(int(cdt == torch.bfloat16), G, N, K, n_radial,
                                                    ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"nbr_edge_features_occupancy failed with CUDA error {err}")
    return dict(zip(_OCCUPANCY, out))


def nbr_edge_features_plain(pos, nbr_idx, superset, cutoff: float, n_radial: int, cdt):
    """The plain PyTorch version of the kernel (same function, same
    rounding: K1's plain arithmetic). The cutoff is rounded to f32 first, as
    the kernel receives it."""
    cutoff = float(torch.tensor(cutoff, dtype=torch.float32))
    pos = pos.to(torch.float32)
    G, N, K = nbr_idx.shape
    superset = superset.to(torch.bool)
    own = torch.arange(N, device=pos.device)[None, :, None].expand(G, N, K)
    d = gather_neighbors(pos, torch.where(superset, nbr_idx, own)) - pos[:, :, None, :]
    dx, dy, dz = d.unbind(-1)
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    mask = (superset & (dist < cutoff)).to(torch.float32)
    feats = _features(dx, dy, dz, mask, cutoff, n_radial, cdt)
    sh = torch.cat([torch.zeros_like(feats[..., :1]), feats[..., :3]], dim=-1)
    idx = torch.where(mask > 0, nbr_idx, torch.full_like(nbr_idx, N))
    return sh, feats[..., 4:], mask, idx


def nbr_edge_features(
    pos: torch.Tensor,
    nbr_idx: torch.Tensor,
    superset: torch.Tensor,
    cutoff: float,
    n_radial: int = 32,
    compute_dtype: torch.dtype = torch.float32,
):
    """(sh [G, N, K, 4], radial [G, N, K, n_radial], mask [G, N, K] f32,
    folded indices [G, N, K] int64). CPU tensors take the plain version;
    CUDA tensors launch the kernel. The features carry no gradient to the
    positions: a position that requires one raises (on both devices)."""
    if pos.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "nbr_edge_features: no gradient with respect to the positions (the model sends "
            "calls that want a gradient to the plain sparse path; "
            "ROADMAP.md queue A, 'Position gradients through the kernels')"
        )
    cutoff = float(cutoff)
    if pos.device.type == "cpu":
        return nbr_edge_features_plain(pos, nbr_idx, superset, cutoff, n_radial, compute_dtype)
    if pos.device.type != "cuda":
        raise ValueError(f"nbr_edge_features: unsupported device {pos.device}")
    if compute_dtype not in _ENTRY:
        raise TypeError(f"nbr_edge_features: compute dtype {compute_dtype} not supported")
    G, N, K = nbr_idx.shape
    checks = [
        ("pos", pos, torch.float32, (G, N, 3)),
        ("nbr_idx", nbr_idx, torch.int64, (G, N, K)),
        ("superset", superset, torch.bool, (G, N, K)),
    ]
    for name, t, dt, shape in checks:
        if t.device != pos.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"nbr_edge_features: {name} must be {dt} {shape} contiguous on {pos.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    check_limits(G, N, K, n_radial, compute_dtype)
    dev = pos.device
    sh = torch.empty((G, N, K, 4), dtype=compute_dtype, device=dev)
    rad = torch.empty((G, N, K, n_radial), dtype=compute_dtype, device=dev)
    mask = torch.empty((G, N, K), dtype=torch.float32, device=dev)
    idx = torch.empty((G, N, K), dtype=torch.int64, device=dev)
    KERNEL.launch(
        _ENTRY[compute_dtype],
        pos.data_ptr(), nbr_idx.data_ptr(), superset.data_ptr(), cutoff, sh.data_ptr(),
        rad.data_ptr(), mask.data_ptr(), idx.data_ptr(), G, N, K, n_radial,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return sh, rad, mask, idx
