"""The Kabsch alignment's rotation without an SVD (wrapper + plain twin).

Replaces no TPU kernel: JAX's jitted SVD (`jamun_tpu/ops/geometry.py:39`)
runs on the device without a host wait, while `torch.linalg.svd` on the card
reads its error flag on the host. The CUDA kernel is `csrc/kabsch.cu`: one
thread per graph turns the 3 x 3 covariance into the proper rotation by
Horn's quaternion method, with a fixed number of cyclic Jacobi sweeps over
a symmetric 4 x 4 matrix.

Input: H [G, 3, 3] f32, H[g] = sum_n y_c[n] x_c[n]^T. Output: R [G, 3, 3]
f32, the rotation maximising tr(R H), which is JAX's
V diag(1, 1, det(V U^T)) U^T where it is unique. No gradient: the
alignment runs on data (`Denoiser.noise_and_denoise`), so an input that
needs one is refused.
"""

from __future__ import annotations

import ctypes

import torch

from jamun_tpu_torch.ops.cuda.build import CudaKernel

__all__ = ["kabsch_rotation", "kabsch_rotation_plain", "horn_matrix", "KERNEL", "SWEEPS"]

SWEEPS = 8  # cyclic Jacobi sweeps (csrc/kabsch.cu)
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("kabsch", {"kabsch_rotation_f32": [_P, _P, _I, _P]})


def horn_matrix(H: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric 4 x 4 matrix of each covariance: q^T N q = tr(R(q) H)
    for the rotation R(q) of a unit quaternion q = (w, x, y, z)."""
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = (H[:, i].unbind(-1) for i in range(3))
    rows = [
        [xx + yy + zz, yz - zy, zx - xz, xy - yx],
        [yz - zy, xx - yy - zz, xy + yx, zx + xz],
        [zx - xz, xy + yx, -xx + yy - zz, yz + zy],
        [xy - yx, zx + xz, yz + zy, -xx - yy + zz],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def kabsch_rotation_plain(H: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same sweeps, rotations
    and choice of eigenvector, vectorised over the graphs."""
    a = horn_matrix(H.to(torch.float32))
    G = a.shape[0]
    v = torch.eye(4, dtype=a.dtype, device=a.device).expand(G, 4, 4).clone()
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(SWEEPS):
        for p, q in _PAIRS:
            apq = a[:, p, q]
            nz = apq != 0
            tau = (a[:, q, q] - a[:, p, p]) / (2.0 * torch.where(nz, apq, one))
            t = torch.copysign(one, tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(nz, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            rot = torch.eye(4, dtype=a.dtype, device=a.device).expand(G, 4, 4).clone()
            rot[:, p, p], rot[:, q, q], rot[:, p, q], rot[:, q, p] = c, c, s, -s
            a = rot.transpose(1, 2) @ a @ rot
            v = v @ rot
    k = torch.argmax(torch.diagonal(a, dim1=1, dim2=2), dim=1)
    qv = torch.gather(v, 2, k[:, None, None].expand(G, 4, 1))[..., 0]
    w, x, y, z = (qv / qv.norm(dim=1, keepdim=True)).unbind(-1)
    R = [
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (y * x + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (z * x - w * y), 2 * (z * y + w * x), w * w - x * x - y * y + z * z],
    ]
    return torch.stack([torch.stack(r, -1) for r in R], -2)


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """R [G, 3, 3] f32 from the covariances H [G, 3, 3]. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if H.requires_grad:
        raise ValueError("kabsch_rotation: no gradient flows through the alignment")
    if H.device.type == "cpu":
        return kabsch_rotation_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"kabsch_rotation: unsupported device {H.device}")
    if H.dtype != torch.float32 or H.dim() != 3 or tuple(H.shape[1:]) != (3, 3):
        raise ValueError(f"kabsch_rotation: H must be f32 [G, 3, 3], got {H.dtype} {tuple(H.shape)}")
    H = H.contiguous()
    G = H.shape[0]
    R = torch.empty_like(H)
    KERNEL.launch(
        "kabsch_rotation_f32", H.data_ptr(), R.data_ptr(), G,
        torch.cuda.current_stream(H.device).cuda_stream,
    )
    return R
