"""Real Clebsch-Gordan coefficients in e3nn's real basis (l = 1 components in
(y, z, x) order), computed on the host: a frozen copy of the port's
`jamun_tpu_torch/ops/cg.py`, for the reference alone."""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["real_wigner_3j"]


@functools.lru_cache(maxsize=None)
def _su2_cg_coeff(idx1: tuple, idx2: tuple, idx3: tuple) -> float:
    """Clebsch-Gordan coefficient <j1 m1 j2 m2 | j3 m3> (Racah's closed form)."""
    j1, m1 = idx1
    j2, m2 = idx2
    j3, m3 = idx3
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0

    f = math.factorial
    delta = f(j1 + j2 - j3) * f(j1 - j2 + j3) * f(-j1 + j2 + j3) / f(j1 + j2 + j3 + 1)
    c = math.sqrt(
        (2.0 * j3 + 1.0)
        * delta
        * f(j3 + m3)
        * f(j3 - m3)
        * f(j1 - m1)
        * f(j1 + m1)
        * f(j2 - m2)
        * f(j2 + m2)
    )

    kmin = int(max(0, j2 - j3 - m1, j1 - j3 + m2))
    kmax = int(min(j1 + j2 - j3, j1 - m1, j2 + m2))
    s = 0.0
    for k in range(kmin, kmax + 1):
        s += (-1.0) ** k / (
            f(k)
            * f(j1 + j2 - j3 - k)
            * f(j1 - m1 - k)
            * f(j2 + m2 - k)
            * f(j3 - j2 + m1 + k)
            * f(j3 - j1 - m2 + k)
        )
    return c * s


@functools.lru_cache(maxsize=None)
def su2_clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """Complex-basis CG tensor of shape [2j1+1, 2j2+1, 2j3+1], m ordered -j..j."""
    mat = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1), dtype=np.float64)
    if abs(j1 - j2) <= j3 <= j1 + j2:
        for m1 in range(-j1, j1 + 1):
            for m2 in range(-j2, j2 + 1):
                m3 = m1 + m2
                if abs(m3) <= j3:
                    mat[j1 + m1, j2 + m2, j3 + m3] = _su2_cg_coeff((j1, m1), (j2, m2), (j3, m3))
    return mat


@functools.lru_cache(maxsize=None)
def change_basis_real_from_complex(l: int) -> np.ndarray:
    """Unitary Q[2l+1, 2l+1] with real_Y = Q @ complex_Y.

    Real index order is m = -l..l; for l=1 this yields basis functions (y, z, x).
    Includes the (-i)^l phase that renders the real 3j tensors real-valued.
    """
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    # m < 0 rows: sin-type harmonics, Y_{l,-|m|} = (i/sqrt2)(Y_l^{-|m|} - (-1)^|m| Y_l^{+|m|}).
    for m in range(1, l + 1):
        q[l - m, l - m] = 1j / math.sqrt(2.0)
        q[l - m, l + m] = -1j * (-1.0) ** m / math.sqrt(2.0)
    q[l, l] = 1.0
    # m > 0 rows: cos-type harmonics, Y_{l,+m} = (1/sqrt2)(Y_l^{-m} + (-1)^m Y_l^{+m}).
    for m in range(1, l + 1):
        q[l + m, l - m] = 1.0 / math.sqrt(2.0)
        q[l + m, l + m] = (-1.0) ** m / math.sqrt(2.0)
    return (-1j) ** l * q


@functools.lru_cache(maxsize=None)
def real_wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C[i, j, k] with the orthogonality property
    sum_{ij} C[i,j,k] C[i,j,k'] = delta_{kk'} / (2*l3 + 1).

    Contracting two covariant inputs with C yields an equivariant output:
    C is invariant under simultaneous rotation of all three indices.
    """
    cg = su2_clebsch_gordan(l1, l2, l3)
    q1 = change_basis_real_from_complex(l1)
    q2 = change_basis_real_from_complex(l2)
    q3 = change_basis_real_from_complex(l3)
    out = np.einsum("im,jn,ko,mno->ijk", q1, q2, np.conj(q3), cg.astype(np.complex128))
    if np.max(np.abs(out)) < 1e-12:
        return out.real.copy()
    # `out` is an invariant tensor; the space of invariants in l1 (x) l2 (x) l3 is
    # one-dimensional, so `out` = (complex phase) * (real tensor). Divide out the
    # phase at the largest-magnitude entry and renormalize.
    idx = np.unravel_index(np.argmax(np.abs(out)), out.shape)
    phase = out[idx] / np.abs(out[idx])
    out = (out / phase).real.copy()
    assert np.max(np.abs((np.einsum("im,jn,ko,mno->ijk", q1, q2, np.conj(q3), cg.astype(np.complex128)) / phase).imag)) < 1e-10
    out /= np.sqrt(np.sum(out**2))  # total norm 1 => sum_{ij} C[i,j,k]^2 = 1/(2l3+1) per k
    assert np.max(np.abs(np.einsum("ijk,ijl->kl", out, out) - np.eye(2 * l3 + 1) / (2 * l3 + 1))) < 1e-10, (
        f"real_wigner_3j({l1},{l2},{l3}) failed orthogonality"
    )
    return out
