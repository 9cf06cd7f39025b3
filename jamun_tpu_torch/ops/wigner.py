"""Wigner D matrices in the real (y, z, x) basis (the port's own copy of
`jamun_tpu/ops/wigner.py`), built recursively from the real coupling
tensors of `ops/cg.py`. Host-side numpy; `Irreps.rotation_matrix` and the
equivariance checks use them."""

from __future__ import annotations

import numpy as np

from jamun_tpu_torch.ops.cg import real_wigner_3j

__all__ = ["wigner_D_from_matrix", "random_rotation"]

# (x, y, z) -> (y, z, x) index permutation of the l=1 real basis
_PERM = np.array([1, 2, 0])


def wigner_D_from_matrix(l: int, R: np.ndarray) -> np.ndarray:
    """The representation matrix D^l(R) of a proper rotation R (3x3, acting
    on xyz)."""
    R = np.asarray(R, dtype=np.float64)
    if l == 0:
        return np.ones((1, 1))
    D1 = R[np.ix_(_PERM, _PERM)]
    D = D1
    for ll in range(2, l + 1):
        C = real_wigner_3j(1, ll - 1, ll)
        # D_l[m, k] = (2l+1) * C[i,j,m] D1[i,i'] D_{l-1}[j,j'] C[i',j',k]
        D = (2 * ll + 1) * np.einsum("ijm,ia,jb,abk->mk", C, D1, D, C)
    return D


def random_rotation(rng=None) -> np.ndarray:
    """A uniform random proper rotation matrix (3x3)."""
    rng = rng or np.random.default_rng()
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q
