"""The port's `E3Conv` beyond the l <= 1 kernel shapes, against JAX on the
CPU: the uvu product with SH to l = 2 and hidden `8x0e + 4x1e + 2x2e`, the
experimental product at l <= 1 and with l = 2, and uvw with l = 2. Two
layers, N = 10 with a padded graph. JAX's parameters (every leaf perturbed
by 0.3) reach the port through `params.from_jax_params`.

- f32 output and `Denoiser.score` within 1e-4 of their max (whole models),
  gradients of a projection of the output within 1e-4 of each leaf's max
  (JAX's XLA path with `training=True`); E(3) equivariance of an output
  with an l = 2 block under the port's own Wigner D.
- `use_pallas=True` with l = 2 builds a model that takes no kernel, as
  JAX's gates turn it to XLA (no kernel wrapper is called).
- A JAX flax-msgpack checkpoint of an experimental model, restored as the
  sample CLI restores it, scores bit for bit as the same parameters loaded
  by name, and within 1e-5 of JAX's score.
- The experimental product in bf16, held as tests/test_torch_bf16.py holds
  the flagship: its error against JAX's f32 forward at most twice JAX's
  bf16 XLA path's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from jamun_tpu.train.state import create_train_state as j_create_train_state
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.cmdline.common import build_denoiser, build_optimizer
from jamun_tpu_torch.cmdline.sample import apply_arch_kernel_defaults
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cuda import conv_block, dense_conv, e3_stack, edge_features, nbr_conv
from jamun_tpu_torch.params import from_jax_params, to_jax_params
from jamun_tpu_torch.train.checkpoints import restore_checkpoint
from jamun_tpu_torch.train.state import create_train_state
from jamun_tpu_torch.utils.equivariance import equivariance_error
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA, CUTOFF = 0.04, 0.9
L2 = dict(irreps_sh="1x0e + 1x1e + 1x2e", irreps_hidden="8x0e + 4x1e + 2x2e")
ARCHS = {
    "uvu l2": dict(tensor_product="uvu", **L2),
    "experimental l1": dict(tensor_product="experimental", irreps_hidden="8x0e + 4x1e"),
    "experimental l2": dict(tensor_product="experimental", **L2),
    "uvw l2": dict(tensor_product="uvw", **L2),
}
BATCH = dict(num_graphs=2, max_nodes=10, nodes_per_graph=[10, 8], max_bonds=20, scale=0.35, seed=1)
CONFIG = dict(max_radius=1.0, average_squared_distance=0.3)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree) -> dict:
    return {k: v.numpy() for k, v in from_jax_params(tree).items()}


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )


def _c_noise():
    return np.asarray([np.log(SIGMA) / 4.0], np.float32)


@functools.lru_cache(maxsize=None)
def _setup(name, n_layers=2, **extra):
    """JAX's module, its perturbed parameters, both batches and the port's
    module (f32, CPU) on those parameters."""
    arch = dict(ARCHS[name], n_layers=n_layers, **dict(extra))
    jb, tb = j_make_test_batch(**BATCH), make_test_batch(**BATCH, device="cpu")
    jm = JE3Conv(**arch)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jb, jnp.asarray(_c_noise()), CUTOFF), 10)
    tm = E3Conv(**arch, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    back = to_jax_params(tm.state_dict())  # and back to flax's tree, leaf for leaf
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    return jm, params, jb, tm, tb


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_e3conv_matches_jax_with_gradients(name):
    """The forward within 1e-4 of its max; the gradients of sum(out * proj)
    in every parameter within 1e-4 of each leaf's max. A leaf whose gradient
    is 0 in JAX (an embedding row the batch does not index, the head's
    scalars and l = 2 copies, which no `1x1e` output reads) is 0 in the port
    too."""
    jm, params, jb, tm, tb = _setup(name)
    assert not tm.kernels
    proj = np.random.default_rng(7).standard_normal((2, 10, 3)).astype(np.float32)
    c = jnp.asarray(_c_noise())

    @jax.jit
    def out_and_grads(p):  # one trace of the forward and its backward
        out, pull = jax.vjp(lambda q: jm.apply(q, jb, c, CUTOFF, training=True), p)
        return out, pull(jnp.asarray(proj))[0]

    jout, jgrads = out_and_grads(params)
    jout, jgrads = np.asarray(jout), _flat(jgrads)
    tm.zero_grad()
    out = tm(tb, torch.from_numpy(_c_noise()), CUTOFF)
    assert np.abs(jout).max() > 1e-2
    assert _rel(out.detach().numpy(), jout) < 1e-4
    (out * torch.from_numpy(proj)).sum().backward()
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(jgrads)
    live = [n for n, g in jgrads.items() if np.abs(g).max() > 0]
    assert len(live) >= 0.85 * len(jgrads), sorted(set(jgrads) - set(live))
    for n, ref in jgrads.items():
        if n in live:
            assert _rel(got[n], ref) < 1e-4, (n, _rel(got[n], ref))
        else:
            assert np.abs(got[n]).max() == 0, n


@pytest.mark.parametrize("name", ["uvu l2", "experimental l2"])
def test_score_matches_jax(name):
    """`Denoiser.score` (f32, alignment off in the score as in JAX) within
    1e-4 of its max, on the dense path and (uvu l2) on the sparse path with
    capped lists of 6 neighbours."""
    modes = ["dense", "nbr"] if name == "uvu l2" else ["dense"]
    for mode in modes:
        jm, params, jb, tm, tb = _setup(name, neighbor_mode=mode, neighbor_cap=6)
        jden, den = JDenoiser(jm, JConfig(**CONFIG)), Denoiser(tm, DenoiserConfig(**CONFIG))
        want = np.asarray(jax.jit(jden.score)({"params": params["params"]}, jb, SIGMA))
        with torch.no_grad():
            got = den.score(tb, SIGMA).numpy()
        assert _rel(got, want) < 1e-4, mode


@pytest.mark.parametrize("name", ["uvu l2", "experimental l2"])
def test_l2_output_equivariant(name):
    """An output with an l = 2 block (`2x0e + 1x1e + 1x2e`): f(R x + t) =
    D(R) f(x) within 1e-4 of the max, D from the port's `ops/wigner.py`."""
    irreps_out = "2x0e + 1x1e + 1x2e"
    tm = E3Conv(**ARCHS[name], n_layers=2, irreps_out=irreps_out, device="cpu", seed=3)
    with torch.no_grad():
        tm.output_gain.fill_(1.0)
    tb = make_test_batch(**BATCH, device="cpu")
    c = torch.from_numpy(_c_noise())
    fn = lambda b: tm(b, c, CUTOFF)  # noqa: E731
    scale = float(fn(tb).detach().abs().max())
    assert scale > 1e-3
    assert equivariance_error(fn, tb, irreps_out=irreps_out) / scale < 1e-4


def test_use_pallas_with_l2_takes_no_kernel(monkeypatch):
    """`use_pallas=True` (the default) with l = 2 SH or hidden irreps, or
    with the experimental product, builds a model whose structure takes no
    kernel (JAX's gates send it to XLA): `kernels` is False, `fused_stack`
    changes nothing, and no kernel wrapper is called in a forward. The
    flagship's structure (uvu, `Sx0e + Vx1e`, `1x0e + 1x1e`) still takes
    them."""
    calls = []
    for mod, names in ((edge_features, ["edge_features"]), (conv_block, ["fused_conv_block",
                       "conv_block_trainable", "conv_layer"]), (e3_stack, ["e3conv_stack"]),
                       (nbr_conv, ["nbr_uvu_conv"]), (dense_conv, ["packed_uvu_conv_dense",
                                                                   "fused_uvu_conv_dense"])):
        for n in names:
            monkeypatch.setattr(mod, n, lambda *a, _n=n, **k: calls.append(_n))
    tb = make_test_batch(**BATCH, device="cpu")
    for arch in (ARCHS["uvu l2"], ARCHS["experimental l1"], dict(tensor_product="uvu", irreps_hidden="8x0e + 4x1e",
                                                                  irreps_sh="1x0e + 1x1e + 1x2e"),
                 dict(tensor_product="uvu", irreps_hidden="8x0e + 4x1e + 2x2e")):
        tm = E3Conv(**arch, n_layers=1, use_pallas=True, fused_stack=True, device="cpu", seed=0)
        assert tm.kernels is False and not tm.plain
        with torch.no_grad():
            out = tm(tb, torch.from_numpy(_c_noise()), CUTOFF)
        assert out.shape == (2, 10, 3) and torch.isfinite(out).all()
    assert calls == []
    assert E3Conv(irreps_hidden="8x0e + 4x1e", tensor_product="uvu", n_layers=1, device="cpu").kernels
    assert not E3Conv(irreps_hidden="8x0e + 4x1e", tensor_product="uvu", n_layers=1, device="cpu",
                      irreps_out="1x1e + 1x2e").kernels


def test_jax_checkpoint_of_experimental_model_scores_bit_for_bit(tmp_path):
    """JAX's `create_train_state` and `save_checkpoint` of an experimental
    model (EMA moved off the parameters), then the sample CLI's path: the
    model built from its config (`build_denoiser`, `apply_arch_kernel_defaults`
    on the CPU), `create_train_state`, `restore_checkpoint`. Parameters and
    EMA bit for bit; the EMA score equal bit for bit to the same EMA loaded
    by `from_jax_params`, and within 1e-5 of JAX's."""
    arch = dict(ARCHS["experimental l1"], n_layers=2)
    jb = j_make_test_batch(**BATCH)
    jden = JDenoiser(JE3Conv(**arch), JConfig(**CONFIG))
    jstate = j_create_train_state(jden, optax.adam(2e-3), jb, seed=0)
    jstate = jstate.replace(params=_perturbed(jstate.params, 20), ema_params=_perturbed(jstate.params, 21))
    path = str(tmp_path / "last.ckpt")
    j_save_checkpoint(path, jstate)

    model_cfg = {
        "arch": {"_target_": "jamun_tpu.models.E3Conv", **arch},
        "optim": {"_target_": "optax.adam", "_partial_": True, "learning_rate": 2e-3},
        **CONFIG,
    }
    apply_arch_kernel_defaults({}, model_cfg, on_card=False)
    den = build_denoiser(model_cfg, device="cpu", seed=0)
    state = create_train_state(den, build_optimizer(model_cfg), seed=0, device="cpu")
    restore_checkpoint(path, state)
    for tree, module in ((jstate.params, state.module), (jstate.ema_params, state.ema)):
        want, got = _flat(tree), module.state_dict()
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            assert np.array_equal(got[k].numpy().view(np.uint32), v.view(np.uint32)), k

    tb = make_test_batch(**BATCH, device="cpu")
    by_name = E3Conv(**arch, plain=True, device="cpu")
    by_name.load_state_dict(from_jax_params(jstate.ema_params), strict=True)
    with torch.no_grad():
        got = Denoiser(state.ema, den.config).score(tb, SIGMA)
        ref = Denoiser(by_name, den.config).score(tb, SIGMA)
    assert torch.equal(got, ref)
    want = np.asarray(jax.jit(jden.score)(jstate.ema_params, jb, SIGMA))
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_experimental_bf16_within_jax_bf16_error(seed):
    """The experimental product in bf16 (`dtype="bfloat16"`, two layers) on
    six graphs of up to 10 atoms: max |port bf16 - JAX f32| <= 2 max |JAX
    bf16 - JAX f32|. The rounding is a sample: on one two-graph batch the
    ratio reached 2.01, on these batches it is 0.87-1.39. There is no cap
    of its own: JAX's bf16 error reaches 4.0% of the max at seed 2."""
    batch = dict(num_graphs=6, max_nodes=10, nodes_per_graph=[10, 8, 10, 9, 10, 7], max_bonds=20,
                 scale=0.35, seed=seed)
    jb, tb = j_make_test_batch(**batch), make_test_batch(**batch, device="cpu")
    arch = dict(ARCHS["experimental l1"], n_layers=2)
    jm, c = JE3Conv(**arch), jnp.asarray(_c_noise())
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jb, c, CUTOFF), 10)
    ref = np.asarray(jax.jit(lambda p: jm.apply(p, jb, c, CUTOFF))(params), np.float64)
    jbf = JE3Conv(**arch, dtype=jnp.bfloat16)
    jerr = np.abs(np.asarray(jax.jit(lambda p: jbf.apply(p, jb, c, CUTOFF))(params), np.float64) - ref).max()
    tm = E3Conv(**arch, dtype="bfloat16", device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = tm(tb, torch.from_numpy(_c_noise()), CUTOFF).to(torch.float64).numpy()
    port_err = np.abs(got - ref).max()
    assert np.isfinite(got).all() and 0 < jerr and np.abs(ref).max() > 1e-2
    assert port_err <= 2 * jerr, (port_err / jerr, jerr / np.abs(ref).max())


def test_seeded_parameters_keep_their_draw_order():
    """`E3Conv(seed=...)` draws every module's weights from one generator in
    module order, so a Conv registers its radial MLP before its
    post-linear, as it did before the generic products came: the same seed
    gives the same flagship weights (and training run) as before."""
    for tp in ("uvu", "uvw", "experimental"):
        tm = E3Conv(irreps_hidden="8x0e + 4x1e", n_layers=1, tensor_product=tp, device="cpu")
        names = [n for n, _ in tm.ConvBlock_0.Conv_0.named_children()]
        assert names == (["radial_nn", "_post_linear"] if tp == "uvu" else ["radial_nn"]), (tp, names)
