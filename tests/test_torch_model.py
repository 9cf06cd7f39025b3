"""The port's whole slice against JAX (CPU, f32): E3Conv -> xhat -> score,
the BAOAB step under injected noise, the save grid, the param bridge, the
device rule and E(3) equivariance.

The JAX side runs with use_pallas=False (its XLA reference path); the port
runs its kernel path, which on the CPU goes through the kernels' plain twins.
Parameters: JAX `Denoiser.init`, every leaf perturbed with seeded numpy noise
(so output_gain and the identity-initialised noise scalings are non-trivial).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.sampling.mcmc import BAOAB as JBAOAB, MCMCConfig as JMCMCConfig
from jamun_tpu.sampling.mcmc import make_processed_score_fn as j_processed
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params, to_jax_params
from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig, make_processed_score_fn
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")


def _setup(n_atoms, seed=0):
    kw = dict(num_graphs=2, max_nodes=n_atoms, max_bonds=2 * n_atoms, scale=0.35, seed=seed)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    jden = JDenoiser(JE3Conv(**ARCH, use_pallas=False), JConfig(1.0, 0.5))
    params = jden.init(jax.random.PRNGKey(seed), jb)
    rng = np.random.default_rng(100 + seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )
    arch = E3Conv(**ARCH, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    return jden, params, jb, Denoiser(arch, DenoiserConfig(1.0, 0.5)), tb


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n_atoms", [8, 19])
def test_slice_matches_jax(n_atoms):
    """E3Conv output, xhat and score at N = 8 and 19 (with a padded atom)."""
    jden, params, jb, den, tb = _setup(n_atoms)
    assert abs(float(params["params"]["output_gain"])) > 0.05
    with torch.no_grad():
        got_x = den.xhat(tb, SIGMA).numpy()
        got_s = den.score(tb, SIGMA).numpy()
    want_x, want_s = map(
        np.asarray,
        jax.jit(lambda p: (jden.xhat(p, jb, SIGMA), jden.score(p, jb, SIGMA)))(params),
    )
    # the network's share of xhat is not vanishing: c_out * g is visible
    assert np.abs(want_s).max() > 1.0
    # xhat: f32 summation-order differences only
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-5)
    # score = (xhat - y) / sigma^2 multiplies xhat's error by 625: relative
    assert _rel_err(got_s, want_s) < 1e-4


@pytest.mark.parametrize("n_atoms", [8, 19])
def test_kernel_path_matches_plain_path(n_atoms):
    """The kernel path (K1 + K2 twins) and the module-level plain path of the
    port compute the same E3Conv forward."""
    _, params, _, den, tb = _setup(n_atoms, seed=1)
    plain = E3Conv(**ARCH, plain=True, device="cpu")
    plain.load_state_dict(from_jax_params(params), strict=True)
    c_noise = torch.tensor([np.log(SIGMA) / 4.0], dtype=torch.float32)
    with torch.no_grad():
        a = den.arch(tb, c_noise, 0.9).numpy()
        b = plain(tb, c_noise, 0.9).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.abs(b).max() > 1e-2


def test_param_bridge_round_trip():
    _, params, _, den, _ = _setup(8)
    back = to_jax_params(den.arch.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b) == 70
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf), err_msg=str(path))


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def test_score_equivariance():
    """score(R y + t) = R score(y) - t / sigma^2 for a random rotation and
    translation (xhat is mean-centred, y is not)."""
    _, _, _, den, tb = _setup(19, seed=2)
    R = torch.from_numpy(_rotation(3).astype(np.float32))
    shift = torch.tensor([0.3, -0.2, 0.5])
    mask = tb.node_mask[..., None].float()
    with torch.no_grad():
        s = den.score(tb, SIGMA)
        s_rot = den.score(tb.replace_pos((tb.pos @ R.T + shift) * mask), SIGMA)
    err = (s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()
    assert float(err) < 1e-4


def test_baoab_step_matches_jax():
    """Three BAOAB steps with the same injected Gaussian draws, the real
    denoiser scores on both sides and an active norm clip."""
    jden, params, jb, den, tb = _setup(8, seed=3)
    cfg_kw = dict(delta=0.04, friction=1.0, M=1.0, steps=4, score_fn_clip=5.0)
    jcfg, cfg = JMCMCConfig(**cfg_kw), MCMCConfig(**cfg_kw)
    rng = np.random.default_rng(9)
    draws = [rng.standard_normal(jb.pos.shape).astype(np.float32) for _ in range(3)]
    it = iter(draws)

    jscore = jax.jit(lambda y: jden.score(params, jb.replace_pos(y), SIGMA))
    jproc = j_processed(jscore, 1.0, cfg.score_fn_clip)
    with torch.no_grad():
        tproc = make_processed_score_fn(lambda y: den.score(tb.replace_pos(y), SIGMA), 1.0, 5.0)
        y0 = tb.pos
        v0 = torch.from_numpy(rng.standard_normal(jb.pos.shape).astype(np.float32))
        psi, orig = tproc(y0)
        assert float(orig.norm(dim=-1).max()) > 5.0  # the clip is active
        carry = (y0, v0, psi, orig)
        jpsi, jorig, _ = jproc(jnp.asarray(jb.pos))
        jcarry = (jnp.asarray(jb.pos), jnp.asarray(v0.numpy()), jpsi, jorig, None)
        sampler = BAOAB(cfg)
        damp, zeta2 = np.exp(-1.0), np.sqrt(1.0 - np.exp(-2.0))
        for R in draws:
            carry = sampler.step(carry, torch.from_numpy(R), tproc)
            jcarry = JBAOAB._step(
                jcarry, None, jproc, jcfg, damp, zeta2, 1.0, lambda k, s, d: jnp.asarray(next(it))
            )
            # (y, v, clipped score, raw score); the raw score carries xhat's
            # f32 error times 1/sigma^2, so all four are held relative to their max
            for a, b in zip(carry, jcarry[:4]):
                assert _rel_err(a.numpy(), np.asarray(b)) < 1e-4


@pytest.mark.parametrize("steps,save_every,burn_in", [(9, 1, 0), (10, 3, 0), (12, 4, 5), (5, 2, 7)])
def test_save_grid_matches_jax(steps, save_every, burn_in):
    kw = dict(steps=steps, save_every_n_steps=save_every, burn_in_steps=burn_in, delta=0.1)
    jcfg, cfg = JMCMCConfig(**kw), MCMCConfig(**kw)
    assert (cfg.first_save_step, cfg.num_saved_frames) == (
        jcfg.first_save_step, jcfg.num_saved_frames,
    )
    y0 = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
    _, _, jtraj, _ = JBAOAB(jcfg)(jax.random.PRNGKey(0), jnp.asarray(y0), lambda y: -y)
    run = lambda c: BAOAB(c)(torch.from_numpy(y0), lambda y: -y, torch.Generator().manual_seed(0))  # noqa: E731
    _, _, traj, straj = run(cfg)
    assert traj.shape[0] == jtraj.shape[0] == cfg.num_saved_frames
    np.testing.assert_array_equal(straj.numpy(), -traj.numpy())
    # frame k is the state after first_save + k * save_every updates
    for k in range(traj.shape[0]):
        n = cfg.first_save_step + k * save_every
        y_n, _, _, _ = run(dataclasses.replace(cfg, steps=n + 1, burn_in_steps=0, save_every_n_steps=1))
        np.testing.assert_array_equal(traj[k].numpy(), y_n.numpy())


def test_device_rule_and_unported_shapes():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            E3Conv(**ARCH)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_test_batch(2, 8)
    # uvw and the experimental product are ported (tests/test_torch_uvw.py,
    # tests/test_torch_general_l.py): they build, on no kernel path
    exp = E3Conv(irreps_hidden="16x0e + 8x1e", tensor_product="experimental", device="cpu")
    assert exp.tensor_product == "experimental" and not exp.kernels
    with pytest.raises(ValueError, match="tensor_product"):
        E3Conv(irreps_hidden="16x0e + 8x1e", tensor_product="uuu", device="cpu")
    # the sparse capped-neighbour path is ported: "nbr" runs at any size and
    # reports the edges its cap drops
    nbr = E3Conv(**ARCH, neighbor_mode="nbr", neighbor_cap=4, device="cpu", seed=0)
    assert (nbr.neighbor_mode, nbr.neighbor_cap, nbr.nbr_geom_kernel) == ("nbr", 4, False)
    with torch.no_grad():
        out, tel = nbr(make_test_batch(2, 8, device="cpu"), torch.tensor([-0.8]), 1.0,
                       with_telemetry=True)
    assert out.shape == (2, 8, 3) and torch.isfinite(out).all()
    assert tel["neighbor_overflow"].shape == (2,) and int(tel["neighbor_overflow"].min()) > 0


def test_kernel_path_head_matches_jax_bf16():
    """The EquivariantMLP head of the bf16 kernel path against JAX's
    `E3Conv._transposed_head` (the head of its chained kernel path) at
    N = 8, `16x0e + 8x1e`, one hidden layer. Both sides round at the same
    points (inputs, weights, divisor, every product and activation in bf16),
    so the outputs are equal bit for bit; the f32 head the port ran before
    differs by about one bf16 step. The whole bf16 E3Conv cannot be held to
    JAX here: JAX on the CPU refuses the bf16 x bf16 -> f32 products of its
    interpret-mode kernels."""
    from jamun_tpu.ops.irreps import Irreps as JIrreps

    arch_kw = dict(irreps_hidden="16x0e + 8x1e", n_layers=1, tensor_product="uvu")
    S, V, N = 16, 8, 8
    jb = j_make_test_batch(num_graphs=2, max_nodes=N, max_bonds=16, scale=0.35)
    jm = JE3Conv(**arch_kw, use_pallas=True, dtype=jnp.bfloat16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb, jnp.zeros((1,)), 1.2)
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )
    x = rng.standard_normal((2, N, S + 3 * V)).astype(np.float32)
    xT = np.zeros((2, 16 + 3 * 16, N), np.float32)  # kernel-native [G, Sp + 3Vp, N]
    xT[:, :S] = x[..., :S].transpose(0, 2, 1)
    xv = x[..., S:].reshape(2, N, V, 3)
    for c in range(3):
        xT[:, 16 + 16 * c : 16 + 16 * c + V] = xv[..., c].transpose(0, 2, 1)
    want = jm.apply(params, jnp.asarray(xT), JIrreps("16x0e + 8x1e"), JIrreps("1x1e"),
                    method=JE3Conv._transposed_head)
    assert want.dtype == jnp.bfloat16
    arch = E3Conv(**arch_kw, dtype=torch.bfloat16, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = arch._kernel_head(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.abs(want).max() > 0.1
