"""Masked mean-centering and batched Kabsch alignment of padded [G, N, 3]
batches (counterpart of `jamun_tpu/ops/geometry.py`)."""

from __future__ import annotations

import torch

from jamun_tpu_torch.ops.cuda.kabsch import kabsch_rotation

__all__ = ["mean_center", "kabsch_align", "svd_rotation"]


def mean_center(pos: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Subtract the per-graph masked centroid; padded atoms are zeroed."""
    m = node_mask[..., None].to(pos.dtype)
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (pos * m).sum(dim=1, keepdim=True) / count
    return (pos - mean) * m


def svd_rotation(H: torch.Tensor) -> torch.Tensor:
    """R = V diag(1, 1, det(V U^T)) U^T from the SVD H = U S V^T of each
    covariance [G, 3, 3] (JAX's rotation; on the card the SVD makes the
    host wait)."""
    U, _, Vh = torch.linalg.svd(H)
    det = torch.linalg.det(torch.einsum("gki,gjk->gij", Vh, U))
    signs = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return torch.einsum("gki,gk,gjk->gij", Vh, signs, U)


def kabsch_align(y: torch.Tensor, x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Rigidly align each graph of y onto the same graph of x (the rotation
    and translation that minimise the masked RMSD), reflections removed.
    Returns the aligned y with padded atoms zeroed.

    R = V diag(1, 1, det(V U^T)) U^T from the SVD of the 3x3 covariance. A
    solver may return U and V with other column signs than LAPACK's; R does
    not depend on them while the singular values are distinct.

    On the card the same rotation comes from `ops.cuda.kabsch` (Horn's
    quaternion, no SVD): `torch.linalg.svd` there reads its error flag on
    the host, a wait in every aligned training step. No gradient flows
    through that path."""
    m = node_mask[..., None].to(y.dtype)
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    x_mu = (x * m).sum(dim=1, keepdim=True) / count
    y_mu = (y * m).sum(dim=1, keepdim=True) / count
    x_c = (x - x_mu) * m
    y_c = (y - y_mu) * m

    H = torch.einsum("gni,gnj->gij", y_c, x_c)
    R = kabsch_rotation(H) if H.device.type == "cuda" else svd_rotation(H)

    Ry = torch.einsum("gij,gnj->gni", R, y)
    t = x_mu - torch.einsum("gij,gnj->gni", R, y_mu)
    return (Ry + t) * m
