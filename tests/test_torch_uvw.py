"""The port's fully connected (uvw) product against JAX (CPU, f32): the real
Clebsch-Gordan tensors, `WeightedTensorProduct`, `E3Conv(tensor_product=
"uvw")` forward and gradients on the dense and the sparse path, E(3)
equivariance, and the denoiser's training loss.

JAX runs uvw through XLA einsums (no Pallas kernel reaches it), and so does
the port through PyTorch's. Parameters: JAX `init`, every leaf perturbed with
seeded numpy noise so that no gradient is trivially 0. Each tolerance is
written beside its check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.cg import real_wigner_3j as j_real_wigner_3j
from jamun_tpu.ops.tensor_product import fully_connected_tp as j_fully_connected_tp
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cg import real_wigner_3j
from jamun_tpu_torch.ops.tensor_product import fully_connected_tp
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvw")


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path[1:]): np.asarray(v) for path, v in flat}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )


@pytest.mark.parametrize("ls", [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0), (1, 1, 1), (1, 1, 2), (2, 1, 1),
                                (2, 2, 2), (1, 2, 3)])
def test_real_wigner_3j_equals_jax(ls):
    """The numpy computation is the same code: equal bits."""
    np.testing.assert_array_equal(real_wigner_3j(*ls), j_real_wigner_3j(*ls))


@pytest.mark.parametrize("irreps", [
    ("16x0e + 8x1e", "1x0e + 1x1e", "24x0e + 8x0e + 8x1e"),
    ("12x0e", "1x0e + 1x1e", "20x0e + 4x0e + 4x1e"),
    ("3x0e + 2x1e + 1x2e", "1x0e + 1x1e + 1x2e", "2x0e + 3x1e + 2x2e + 1x1o"),
])
def test_weighted_tensor_product_matches_jax(irreps):
    """Paths, path weights and the product itself, per-element weights,
    within 1e-5 of the output's max (f32 summation order)."""
    tp, jtp = fully_connected_tp(*irreps), j_fully_connected_tp(*irreps)
    assert tp.weight_numel == jtp.weight_numel
    assert [(i.i_in1, i.i_in2, i.i_out, i.path_weight, i.weight_offset, i.weight_shape)
            for i in tp.instructions] == [
        (i.i_in1, i.i_in2, i.i_out, i.path_weight, i.weight_offset, i.weight_shape)
        for i in jtp.instructions]
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((5, 7, tp.irreps_in1.dim)).astype(np.float32)
    x2 = rng.standard_normal((5, 7, tp.irreps_in2.dim)).astype(np.float32)
    w = rng.standard_normal((5, 7, tp.weight_numel)).astype(np.float32)
    got = tp(*map(torch.from_numpy, (x1, x2, w))).numpy()
    want = np.asarray(jtp(*map(jnp.asarray, (x1, x2, w))))
    assert got.shape == want.shape == (5, 7, tp.irreps_out.dim)
    assert _rel(got, want) < 1e-5


def _model_setup(neighbor_mode: str, seed: int = 0, n_atoms: int = 12):
    kw = dict(num_graphs=2, max_nodes=n_atoms, nodes_per_graph=[n_atoms, n_atoms - 2],
              max_bonds=2 * n_atoms, scale=0.35, seed=seed)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    nbr = dict(neighbor_mode=neighbor_mode, neighbor_cap=6)
    jm = JE3Conv(**ARCH, **nbr)
    c_noise = np.asarray([np.log(SIGMA) / 4.0], np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), jb, jnp.asarray(c_noise), 0.9), 10 + seed)
    tm = E3Conv(**ARCH, **nbr, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, jb, tm, tb, c_noise


@pytest.mark.parametrize("neighbor_mode", ["dense", "nbr"])
def test_e3conv_uvw_matches_jax(neighbor_mode):
    """E3Conv(tensor_product="uvw") at 16x0e + 8x1e, 2 layers, N = 12 with a
    padded graph: the f32 output within 1e-4 of its max, and the gradients of
    a random projection of the output within 1e-4 of each leaf's max (sums
    over every pair of the batch). "nbr": capped lists of 6 neighbours (some
    rows drop in-cutoff edges), JAX's generic sparse path."""
    jm, params, jb, tm, tb, c_noise = _model_setup(neighbor_mode)
    assert not tm.kernels  # uvw has no kernel route
    proj = np.random.default_rng(7).standard_normal((2, 12, 3)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, jb, jnp.asarray(c_noise), 0.9, training=True) * proj)

    jout = np.asarray(jm.apply(params, jb, jnp.asarray(c_noise), 0.9))
    jgrads = _flat(jax.grad(jloss)(params))
    out = tm(tb, torch.from_numpy(c_noise), 0.9)
    assert _rel(out.detach().numpy(), jout) < 1e-4
    assert np.abs(jout).max() > 1e-2
    (out * torch.from_numpy(proj)).sum().backward()
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in tm.named_parameters()}
    assert set(got) == set(jgrads)
    # uvw blocks have no post-linear: the radial MLP makes every path's weight
    assert not any("_post_linear" in n for n in got)
    live = [n for n, g in jgrads.items() if np.abs(g).max() > 0]
    assert len(live) >= len(jgrads) - 2, sorted(set(jgrads) - set(live))
    for name, ref in jgrads.items():
        if name in live:
            assert _rel(got[name], ref) < 1e-4, (name, _rel(got[name], ref))
        else:  # an embedding table the batch does not index
            assert np.abs(got[name]).max() == 0, name


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


@pytest.mark.parametrize("neighbor_mode", ["dense", "nbr"])
def test_uvw_score_equivariance(neighbor_mode):
    """score(R y + t) = R score(y) - t / sigma^2 for the uvw denoiser: 1e-4
    of the score's max (f32)."""
    _, _, _, tm, tb, _ = _model_setup(neighbor_mode, seed=2)
    den = Denoiser(tm, DenoiserConfig(1.0, 0.3))
    R = torch.from_numpy(_rotation(3).astype(np.float32))
    shift = torch.tensor([0.3, -0.2, 0.5])
    mask = tb.node_mask[..., None].float()
    with torch.no_grad():
        s = den.score(tb, SIGMA)
        s_rot = den.score(tb.replace_pos((tb.pos @ R.T + shift) * mask), SIGMA)
    err = (s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()
    assert float(err) < 1e-4


def test_uvw_training_loss_matches_jax():
    """The denoiser's training loss (alignment on, noise of ones on both
    sides): loss and metrics within 1e-5 relative."""
    kw = dict(num_graphs=2, max_nodes=12, nodes_per_graph=[12, 10], max_bonds=24, scale=0.35, seed=4)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    jden = JDenoiser(JE3Conv(**ARCH), JConfig(1.0, 0.3, add_fixed_ones=True))
    params = _perturbed(jden.init(jax.random.PRNGKey(4), jb), 14)
    arch = E3Conv(**ARCH, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    den = Denoiser(arch, DenoiserConfig(1.0, 0.3, add_fixed_ones=True))
    jloss, jaux = jden.training_loss(params, jax.random.PRNGKey(0), jb, SIGMA)
    loss, aux = den.training_loss(tb, SIGMA, torch.Generator())
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in ("coordinate_loss", "raw_coordinate_loss", "scaled_rmsd", "loss"):
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k
