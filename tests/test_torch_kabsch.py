"""The SVD-free Kabsch rotation (`ops/cuda/kabsch.py`, the plain twin of
`csrc/kabsch.cu`) against JAX's `kabsch_align` and the port's SVD path
(CPU, f32).

Each case is a numpy-seeded batch of graphs: random rotations with noise,
mirrored inputs (the best orthogonal map is a reflection), near-planar and
collinear point sets, single-atom graphs, padded atoms, up to 32 graphs.
Where the rotation is unique the aligned positions are compared, 1e-5 of the
largest coordinate (f32 SVD on the other side: both are f32 solvers of the
same problem); where it is not (a line, one atom) the aligned RMSD is,
to the same 1e-5 of the largest coordinate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.ops.geometry import kabsch_align as j_kabsch_align
from jamun_tpu_torch.ops.cuda import kabsch as kb
from jamun_tpu_torch.ops.geometry import kabsch_align

TOL = 1e-5


def _rotations(rng, G):
    q = np.linalg.qr(rng.standard_normal((G, 3, 3)))[0]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _case(name, rng):
    """(x, y, mask, degenerate) for one case: f32 [G, N, 3] twice, bool [G, N]."""
    G, N = 32, 12
    x = rng.standard_normal((G, N, 3))
    mask = np.ones((G, N), bool)
    if name == "planar":
        x[..., 2] *= 1e-3
    elif name == "collinear":
        x = rng.standard_normal((G, N, 1)) * rng.standard_normal((G, 1, 3))
    elif name == "padded":
        for g in range(G):
            mask[g, 3 + g % (N - 3):] = False
    elif name == "single":
        mask[:, 1:] = False
    y = np.einsum("gnj,gij->gni", x, _rotations(rng, G)) + 0.05 * rng.standard_normal((G, N, 3))
    if name == "reflected":
        y = y * np.array([1.0, 1.0, -1.0])
    if name == "collinear":  # keep y on a line too: only the rotation about it is free
        y = np.einsum("gnj,gij->gni", x, _rotations(rng, G))
    x, y = (np.where(mask[..., None], a, 0.0).astype(np.float32) for a in (x, y))
    return x, y, mask, name in ("collinear", "single")


def _align_with_twin(y, x, mask):
    """kabsch_align's centring and covariance with the twin's rotation."""
    m = mask[..., None].to(y.dtype)
    count = torch.clamp(m.sum(1, keepdim=True), min=1.0)
    x_mu, y_mu = (x * m).sum(1, keepdim=True) / count, (y * m).sum(1, keepdim=True) / count
    H = torch.einsum("gni,gnj->gij", (y - y_mu) * m, (x - x_mu) * m)
    R = kb.kabsch_rotation(H)
    return (torch.einsum("gij,gnj->gni", R, y) + x_mu - torch.einsum("gij,gnj->gni", R, y_mu)) * m


def _rmsd(a, b, mask):
    m = mask[..., None]
    return np.sqrt(((a - b) ** 2 * m).sum((1, 2)) / np.maximum(mask.sum(1), 1))


@pytest.mark.parametrize("name", ["random", "reflected", "planar", "collinear", "single", "padded"])
def test_twin_matches_jax_and_svd(name):
    x, y, mask, degenerate = _case(name, np.random.default_rng(7))
    got = _align_with_twin(*(torch.from_numpy(a) for a in (y, x, mask))).numpy()
    jax_out = np.asarray(j_kabsch_align(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask)))
    svd_out = kabsch_align(*(torch.from_numpy(a) for a in (y, x, mask))).numpy()
    scale = np.abs(x).max()
    assert np.all(got[~mask] == 0.0)
    for want in (jax_out, svd_out):
        if degenerate:
            err = np.abs(_rmsd(got, x, mask) - _rmsd(want, x, mask)).max()
        else:
            err = np.abs(got - want).max()
        assert err <= TOL * scale, (name, err / scale)


def test_twin_gives_proper_rotations():
    """Every R is orthogonal with det +1, the reflected inputs included."""
    x, y, mask, _ = _case("reflected", np.random.default_rng(3))
    m = torch.from_numpy(mask)[..., None].float()
    yc, xc = torch.from_numpy(y) * m, torch.from_numpy(x) * m
    R = kb.kabsch_rotation(torch.einsum("gni,gnj->gij", yc, xc))
    eye = torch.eye(3).expand_as(R)
    assert (R @ R.transpose(1, 2) - eye).abs().max() < 1e-5
    assert (torch.linalg.det(R) - 1.0).abs().max() < 1e-5


def test_horn_matrix_gives_the_trace():
    """q^T N(H) q = tr(R(q) H) for random unit quaternions: the matrix the
    kernel diagonalises is Horn's for this convention."""
    rng = np.random.default_rng(1)
    H = torch.from_numpy(rng.standard_normal((8, 3, 3)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    q = q / q.norm(dim=1, keepdim=True)
    w, a, b, c = q.unbind(-1)
    R = torch.stack([
        torch.stack([w * w + a * a - b * b - c * c, 2 * (a * b - w * c), 2 * (a * c + w * b)], -1),
        torch.stack([2 * (b * a + w * c), w * w - a * a + b * b - c * c, 2 * (b * c - w * a)], -1),
        torch.stack([2 * (c * a - w * b), 2 * (c * b + w * a), w * w - a * a - b * b + c * c], -1),
    ], -2)
    quad = torch.einsum("gi,gij,gj->g", q, kb.horn_matrix(H), q)
    trace = torch.einsum("gij,gji->g", R, H)
    assert (quad - trace).abs().max() < 1e-4


def test_rotation_refuses_a_gradient():
    """No gradient flows through the alignment: the wrapper says so rather
    than return a rotation autograd cannot follow into the kernel."""
    H = torch.randn(4, 3, 3, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        kb.kabsch_rotation(H)
    kb.kabsch_rotation(H.detach())
