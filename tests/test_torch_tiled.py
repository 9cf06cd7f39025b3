"""The dense path above 128 atoms of the port against JAX (CPU, f32).

JAX side: `packed_fused_block_v2` and `packed_geometry_inputs` as
`tests/test_pallas_conv.py` runs them on the CPU (`interpret=True`, the tiled
grid forced with `dst_block=8`), and `E3Conv(use_pallas=True)`, which takes
that kernel above 128 atoms, beside its XLA path (`use_pallas=False`, and
every differentiated call above 128 atoms). Port side: `fused_block_tiled`
(K5), whose wrapper runs the plain twin `fused_block_tiled_plain` for CPU
tensors, and the model's dispatch around it. Inputs and weights come from
numpy seeds and cross over with `from_jax_params`. Each tolerance is written
beside its check; all are relative to the reference's largest value.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.conv import ConvBlock as JConvBlock
from jamun_tpu.ops.pallas import packed_conv as jpk
from jamun_tpu.sampling.mcmc import BAOAB as JBAOAB, MCMCConfig as JMCMCConfig
from jamun_tpu.sampling.mcmc import make_processed_score_fn as j_processed
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models import e3conv as port_e3conv
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv, neighbor_mode_auto
from jamun_tpu_torch.ops import conv as port_conv
from jamun_tpu_torch.ops.conv import ConvBlock
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import e3_stack as k3
from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5
from jamun_tpu_torch.ops.cuda.edge_features import (
    bond_features_plain,
    edge_features_plain,
    packed_rows,
)
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig, make_processed_score_fn
from jamun_tpu_torch.train.distributions import ConstantSigma
from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
from jamun_tpu_torch.train.optim import adam
from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger, make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
CUTOFF = 0.9
SH = "1x0e + 1x1e"
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")
BIG = dict(num_graphs=2, max_nodes=136, nodes_per_graph=[136, 131], max_bonds=272, scale=0.6)
SHAPES = {
    "n32_dst8": (dict(num_graphs=2, max_nodes=32, nodes_per_graph=[29, 32], max_bonds=64, scale=0.5), 8),
    "n136": (BIG, None),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturbed(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32)),
        tree,
    )


def _geo(tb, cutoff=CUTOFF):
    return k5.tiled_geometry_inputs(
        tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, cutoff, 32
    )


def _block(irreps_in, batch_kw, seed=11):
    """A JAX ConvBlock's perturbed params, the same block in the port, both
    batches, an input and the two bondedness embeddings."""
    from jamun_tpu.ops.graph import EdgeData

    irreps_out = "16x0e + 8x1e"
    jb, tb = j_make_test_batch(**batch_kw), make_test_batch(**batch_kw, device="cpu")
    G, N, B = jb.pos.shape[0], jb.pos.shape[1], jb.bond_src.shape[1]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, N, Irreps(irreps_in).dim)).astype(np.float32)
    bond = rng.standard_normal((2, 32)).astype(np.float32)
    jm = JConvBlock(irreps_in, irreps_out, SH, 64, tensor_product="uvu")
    z = jnp.zeros
    dummy = EdgeData(
        sh_dense=z((G, 8, 8, 4)), attr_dense=z((G, 8, 8, 64)), adj=z((G, 8, 8)),
        sh_bond=z((G, B, 4)), attr_bond=z((G, B, 64)), bond_src=z((G, B), jnp.int32),
        bond_dst=z((G, B), jnp.int32), bond_mask=z((G, B)),
    )
    p = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :8]), dummy), seed + 1, 0.1)
    tm = ConvBlock(irreps_in, irreps_out, SH, 64)
    tm.load_state_dict(from_jax_params(p), strict=True)
    return jb, tb, p["params"], tm, x, bond


@pytest.mark.parametrize("irreps_in", ["16x0e + 8x1e", "24x0e"], ids=["hidden", "projector"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tiled_plain_matches_tpu_kernel(shape, irreps_in):
    """`fused_block_tiled` (its plain twin) against
    `packed_fused_block_v2(interpret=True)`: the tiled grid forced at N = 32
    (`dst_block=8`) and taken by itself at N = 136 (17 dst blocks of 8), a
    ragged batch, a hidden block (V > 0) and the projector (V = 0), weights
    through `pack_block_weights`. f32 on both sides; the TPU kernel folds
    pl1's o2 columns per pair and sums in another order: 1e-5 of the max."""
    batch_kw, dst_block = SHAPES[shape]
    S, V = Irreps(irreps_in).sv_shape()
    jb, tb, pp, tm, x, bond = _block(irreps_in, batch_kw)
    posm, bf, ebsT, ebd = jpk.packed_geometry_inputs(
        jb.pos, jb.node_mask, jb.bond_src, jb.bond_dst, jb.bond_mask, jnp.asarray(CUTOFF), n_radial=32
    )
    rp = pp["Conv_0"]["radial_nn"]
    want = np.asarray(jpk.packed_fused_block_v2(
        jnp.asarray(x), posm, bf, ebsT, ebd,
        rp["Dense_0"]["kernel"], rp["Dense_0"]["bias"], rp["Dense_1"]["kernel"], rp["Dense_1"]["bias"],
        jnp.asarray(bond[0]), jnp.asarray(bond[1]), dict(pp["Conv_0"]["_post_linear"]),
        dict(pp["IrrepsLinear_1"]), dict(pp["IrrepsLinear_0"]), jnp.asarray(CUTOFF),
        S=S, V=V, out_blocks=((16, 0), (8, 0), (8, 1)), n_radial=32, interpret=True,
        dst_block=dst_block,
    ))
    with torch.no_grad():
        w = k2.pack_block_weights(
            tm.Conv_0.radial_nn, tm.Conv_0._post_linear, tm.IrrepsLinear_1, tm.IrrepsLinear_0,
            torch.from_numpy(bond[0]), torch.from_numpy(bond[1]), S=S, V=V, cdt=torch.float32,
        )
        got, deg = k5.fused_block_tiled(torch.from_numpy(x), _geo(tb), w, return_degree=True)
        via_module = tm.fused(torch.from_numpy(x), _geo(tb), torch.from_numpy(bond[0]),
                              torch.from_numpy(bond[1]))
    assert np.abs(want).max() > 0.1 and got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5
    np.testing.assert_array_equal(via_module.numpy(), got.numpy())
    # pairs on both sides of the cutoff, none into a padded atom
    n_real = int(tb.node_mask[0].sum())
    assert 2 < deg[0, :n_real].mean() < n_real and deg[0, n_real:].sum() == 0


def test_geometry_inputs_match_jax():
    """The per-forward inputs against `packed_geometry_inputs`: positions and
    node mask (its posm rows), and the bond features the kernel rebuilds per
    bond (its bf rows), f32 1e-5."""
    jb, tb = j_make_test_batch(**BIG), make_test_batch(**BIG, device="cpu")
    posm, bf, ebsT, _ = jpk.packed_geometry_inputs(
        jb.pos, jb.node_mask, jb.bond_src, jb.bond_dst, jb.bond_mask, jnp.asarray(CUTOFF), n_radial=32
    )
    geo = _geo(tb.replace_pos(tb.pos.double()))  # cast to f32 on the way in
    assert geo.pos.dtype == torch.float32 and geo.pos.is_contiguous()
    np.testing.assert_array_equal(geo.pos.numpy(), np.asarray(posm)[:, :3].transpose(0, 2, 1))
    np.testing.assert_array_equal(geo.node_mask.numpy(), np.asarray(posm)[:, 3] > 0)
    cutoff32 = float(np.float32(CUTOFF))
    got = bond_features_plain(geo.pos, *geo[2:5], cutoff32, 32, torch.float32)
    assert got.shape == (2, 272, 36)
    rows = packed_rows(got.new_zeros((2, 1, 1, 36)), got, 32)[1]
    np.testing.assert_allclose(rows.numpy(), np.asarray(bf), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[..., 3].numpy(), np.asarray(ebsT).sum(1))
    # the same numbers as K1's bond features: one formula for both regimes
    _, bf1 = edge_features_plain(*geo[:5], CUTOFF, 32, torch.float32)
    torch.testing.assert_close(got, bf1, rtol=0, atol=0)


@pytest.mark.parametrize("grad_mode", [True, False], ids=["grad", "no_grad"])
def test_geometry_refuses_position_gradients(grad_mode):
    """`packed_geometry_inputs` refuses dL/dpos; so do the port's geometry
    inputs and K5's wrapper, on the CPU too, instead of dropping it."""
    tb = make_test_batch(**BIG, device="cpu")
    pos = tb.pos.clone().requires_grad_()
    args = (tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, CUTOFF)
    _, _, _, tm, x, bond = _block("24x0e", SHAPES["n32_dst8"][0])
    with torch.set_grad_enabled(grad_mode):
        if grad_mode:
            with pytest.raises(NotImplementedError, match="positions"):
                k5.tiled_geometry_inputs(pos, *args)
            geo = k5.TiledGeometry(pos, *args, 32)
            with pytest.raises(NotImplementedError, match="positions"):
                k5.fused_block_tiled(torch.zeros(2, 136, 24), geo, None)
        else:
            assert k5.tiled_geometry_inputs(pos, *args).pos.shape == pos.shape  # grad mode off: goes
    # a block input or a weight that wants a gradient raises too: forward only
    small = make_test_batch(**SHAPES["n32_dst8"][0], device="cpu")
    with torch.set_grad_enabled(grad_mode):
        call = lambda: tm.fused(torch.from_numpy(x), _geo(small), *map(torch.from_numpy, bond))  # noqa: E731
        if grad_mode:
            with pytest.raises(NotImplementedError, match="queue A, .Tiled kernel training."):
                call()
        else:
            assert call().shape == (2, 32, 40)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tiled_twin_matches_conv_block_twin(cdt, monkeypatch):
    """K5's twin against K2's twin on K1's twin (`fused_conv_block_plain` on
    `edge_features_plain`): the same rounding points, so bit for bit in f32
    and bf16, also when the twin walks the graphs in chunks; and the degree
    it returns is K2's residual degree."""
    _, tb, _, tm, x, bond = _block("16x0e + 8x1e", SHAPES["n32_dst8"][0])
    with torch.no_grad():
        w = k2.pack_block_weights(
            tm.Conv_0.radial_nn, tm.Conv_0._post_linear, tm.IrrepsLinear_1, tm.IrrepsLinear_0,
            torch.from_numpy(bond[0]), torch.from_numpy(bond[1]), S=16, V=8, cdt=cdt,
        )
        xt = torch.from_numpy(x).to(cdt)
        geo = _geo(tb)
        ef, bf = edge_features_plain(*geo[:6], 32, cdt)
        want = k2.fused_conv_block_plain(xt, ef, bf, tb.bond_src, tb.bond_dst, w)
        _, deg_want = k2.conv_block_residuals_plain(xt, ef, bf, tb.bond_src, tb.bond_dst, w)
        got, deg = k5.fused_block_tiled_plain(xt, geo, w, return_degree=True)
        monkeypatch.setattr(k5, "_PLAIN_PAIRS", 1)  # one graph at a time
        chunked = k5.fused_block_tiled_plain(xt, geo, w)
    assert got.dtype == torch.float32 and float(want.abs().max()) > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(chunked, want, rtol=0, atol=0)
    torch.testing.assert_close(deg, deg_want, rtol=0, atol=0)


def test_shared_memory_and_limits():
    """The limits the wrapper holds a launch to: the pair list's index field,
    the grid's graph axis and a block's shared memory, which the kernel's
    library reckons itself for the build of the compute dtype (its first
    argument; the f32 build's list of 8 N + B entries grows it)."""
    assert k5.MAX_ATOMS == 2**19 - 1 and k5.MAX_GRAPHS == 65535
    assert k5.MAX_SHARED_BYTES == 227 * 1024
    assert k5.KERNEL.name == "fused_block_tiled" and k5.KERNEL.source.name == "fused_block_tiled.cu"
    assert k5.KERNEL.entries["fused_block_tiled_smem"] == [ctypes.c_int] * 7
    assert "fused_block_tiled_smem" in k5.KERNEL.source.read_text()
    assert 4 * (8 * 8192 + 8192) > k5.MAX_SHARED_BYTES  # the list alone at N = 8192


# ---- the model above 128 atoms ----


def _models(seed=0, config=None, batch_kw=BIG):
    """(JAX denoisers on the kernel path and on the XLA path, their shared
    params, the JAX batch, the port's denoiser, the port's batch)."""
    config = config or dict(max_radius=1.0, average_squared_distance=0.5)
    jb, tb = j_make_test_batch(**batch_kw), make_test_batch(**batch_kw, device="cpu")
    jdens = {
        path: JDenoiser(JE3Conv(**ARCH, use_pallas=use_pallas, neighbor_mode="dense"), JConfig(**config))
        for path, use_pallas in (("kernel", True), ("xla", False))
    }
    small = j_make_test_batch(num_graphs=1, max_nodes=8)
    params = _perturbed(jdens["xla"].init(jax.random.PRNGKey(seed), small), 300 + seed)
    arch = E3Conv(**ARCH, neighbor_mode="dense", device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    return jdens, params, jb, Denoiser(arch, DenoiserConfig(**config)), tb


@pytest.fixture(scope="module")
def big():
    return _models()


@pytest.mark.parametrize("path", ["kernel", "xla"])
def test_e3conv_and_score_n136_match_jax(big, path, monkeypatch):
    """`E3Conv` and `Denoiser.score` at N = 136 against the JAX model with
    `use_pallas=True` (which takes kernel #5, in interpret mode: counted) and
    against its XLA path. f32; the network output 1e-4 of its max, the score
    ((xhat - y) / sigma^2, which multiplies xhat's error by 625) likewise."""
    jdens, params, jb, den, tb = big
    made = []
    inner = jpk.make_trainable_conv_block_v2
    monkeypatch.setattr(jpk, "make_trainable_conv_block_v2", lambda *a, **k: made.append(1) or inner(*a, **k))
    c_noise = float(np.log(SIGMA) / 4.0)
    jden = jdens[path]
    want_g = np.asarray(jax.jit(jden.arch.apply)(params, jb, jnp.asarray([c_noise]), jnp.asarray(1.3)))
    want_s = np.asarray(jax.jit(lambda p: jden.score(p, jb, SIGMA))(params))
    assert len(made) == (6 if path == "kernel" else 0)  # 3 blocks per traced forward
    den.arch.requires_grad_(False)
    n5 = k5.KERNEL.launches
    with torch.no_grad():
        got_g = den.arch(tb, torch.tensor([c_noise]), 1.3).numpy()
        got_s = den.score(tb, SIGMA).numpy()
    assert k5.KERNEL.launches == n5  # the count moves only where the kernel launches
    assert np.abs(want_g).max() > 1e-2 and np.abs(want_s).max() > 1.0
    assert _rel(got_g, want_g) < 1e-4
    assert _rel(got_s, want_s) < 1e-4


class _Spy:
    """Counts the calls of the kernels' wrappers the model goes through."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for name, module, attr in (
            ("K1", port_e3conv, "edge_features"),
            ("K2", port_conv, "fused_conv_block"),
            ("K2+K4", port_conv, "conv_block_trainable"),
            ("K5", port_conv, "fused_block_tiled"),
            ("K3", k3, "e3conv_stack"),
        ):
            self.calls[name] = 0

            def counted(*a, _name=name, _inner=getattr(module, attr), **k):
                self.calls[_name] += 1
                return _inner(*a, **k)

            monkeypatch.setattr(module, attr, counted)

    def take(self):
        out = {k: v for k, v in self.calls.items() if v}
        for k in self.calls:
            self.calls[k] = 0
        return out


def test_dispatch_by_regime(monkeypatch):
    """Which wrappers a forward goes through: N <= 64 without a gradient the
    stack; N <= 128 K1 once and K2 per block (K2 + K4 under autograd);
    N > 128 without a gradient K5 per block and K1 never, so the model
    itself builds no tensor with two atom axes; N > 128 with a gradient the
    plain path (no wrapper at all), which also gives position gradients."""
    spy = _Spy(monkeypatch)
    c = torch.tensor([-0.8])

    def run(n, grad, **kw):
        batch = make_test_batch(num_graphs=1, max_nodes=n, max_bonds=2 * n, scale=0.6, device="cpu")
        model = E3Conv(**ARCH, device="cpu", seed=0, **kw).requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            out = model(batch, c, 1.0)
        return spy.take(), out, model, batch

    assert run(64, False, fused_stack=True)[0] == {"K3": 1}
    assert run(65, False, fused_stack=True)[0] == {"K1": 1, "K2": 3}
    assert run(128, False)[0] == {"K1": 1, "K2": 3}
    assert run(128, True)[0] == {"K1": 1, "K2+K4": 3}
    assert run(129, False, fused_stack=True)[0] == {"K5": 3}
    calls, out, model, batch = run(129, True)
    assert calls == {} and out.requires_grad
    # the plain path is differentiable in the positions; the kernel path refuses
    pos = batch.pos.clone().requires_grad_()
    model.output_gain.data.fill_(1.0)
    model(batch.replace_pos(pos), c, 1.0).square().sum().backward()
    assert spy.take() == {} and float(pos.grad.abs().max()) > 0
    with pytest.raises(NotImplementedError, match="positions"):
        E3Conv(**ARCH, device="cpu", seed=0)(
            make_test_batch(num_graphs=1, max_nodes=16, device="cpu").replace_pos(
                torch.zeros(1, 16, 3, requires_grad=True)), c, 1.0)


def test_auto_neighbor_mode_follows_jax():
    """`"auto"` is the default and resolves as JAX's `neighbor_mode_auto`
    (256 atoms with a gradient, 512 without); where it goes sparse the port
    runs the sparse path (its telemetry reports the cap's dropped edges),
    and `"dense"` runs the dense path at any size."""
    from jamun_tpu.models.e3conv import neighbor_mode_auto as j_auto

    for n in (128, 255, 256, 511, 512, 1024):
        for training in (False, True):
            assert neighbor_mode_auto(n, training) == j_auto(n, training), (n, training)
    tiny = dict(irreps_hidden="4x0e + 2x1e", n_layers=1, tensor_product="uvu")
    c = torch.tensor([-0.8])
    auto = E3Conv(**tiny, device="cpu", seed=0)
    assert auto.neighbor_mode == "auto" == JE3Conv.neighbor_mode
    at = lambda n: make_test_batch(num_graphs=1, max_nodes=n, max_bonds=8, scale=2.0, device="cpu")  # noqa: E731
    # parameters want a gradient: the training threshold, the plain sparse path
    out, tel = auto(at(256), c, 1.0, with_telemetry=True)
    assert out.shape == (1, 256, 3) and "neighbor_overflow" in tel and out.requires_grad
    auto.requires_grad_(False)
    out, tel = auto(at(256), c, 1.0, with_telemetry=True)
    assert out.shape == (1, 256, 3) and tel == {}  # dense below 512 without a gradient
    out, tel = auto(at(512), c, 1.0, with_telemetry=True)
    assert torch.isfinite(out).all() and tel["neighbor_overflow"].shape == (1,)
    dense = E3Conv(**tiny, neighbor_mode="dense", device="cpu", seed=0).requires_grad_(False)
    out, tel = dense(at(512), c, 1.0, with_telemetry=True)
    assert torch.isfinite(out).all() and tel == {}
    with pytest.raises(ValueError, match="neighbor_mode"):
        E3Conv(**tiny, neighbor_mode="sparse", device="cpu")


def test_params_tree_unchanged_above_128(big):
    """The path above 128 atoms adds no parameter: the state dict is the
    flax tree, key for key, and a forward at N = 136 leaves it so."""
    _, params, _, den, tb = big
    keys = list(den.arch.state_dict())
    assert set(from_jax_params(params)) == set(keys) and len(keys) == 70
    with torch.no_grad():
        den.score(tb, SIGMA)
    assert list(den.arch.state_dict()) == keys


def test_training_loss_and_grads_n136_match_jax():
    """`training_loss` and its gradients at N = 136 (the port's training
    dispatch: the plain path) against JAX's `value_and_grad` with
    `use_pallas=True`, whose `training=True` call takes XLA above 128 atoms.
    The same noise through `add_fixed_ones`. Loss 1e-5 relative; gradients
    1e-4 of each leaf's max."""
    config = dict(max_radius=1.0, average_squared_distance=0.3, add_fixed_ones=True)
    jdens, params, jb, den, tb = _models(seed=1, config=config)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jdens["kernel"].training_loss, has_aux=True))(
        params, jax.random.PRNGKey(0), jb, SIGMA
    )
    n2, n5 = k2.KERNEL.launches, k5.KERNEL.launches
    loss, _ = den.training_loss(tb, SIGMA, torch.Generator())
    loss.backward()
    assert (k2.KERNEL.launches, k5.KERNEL.launches) == (n2, n5)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    want = {".".join(k.key for k in path[1:]): np.asarray(v) for path, v in flat}
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in den.arch.named_parameters()}
    assert set(got) == set(want)
    live = [n for n, g in want.items() if np.abs(g).max() > 0]
    assert len(live) >= 66
    for name in live:
        assert _rel(got[name], want[name]) < 1e-4, (name, _rel(got[name], want[name]))


def test_trainer_fit_takes_a_batch_above_128(monkeypatch, tmp_path):
    """One `Trainer.fit` step and an EMA validation at N = 136 on the CPU:
    the step runs the plain path, the validation (no gradient) K5."""
    spy = _Spy(monkeypatch)
    tb = make_test_batch(**BIG, device="cpu")
    den = Denoiser(E3Conv(**ARCH, device="cpu", seed=0), DenoiserConfig(1.0, 0.3))
    rec = RecordingLogger()
    cfg = TrainerConfig(max_steps=1, log_every_n_steps=1, checkpoint_dir=str(tmp_path / "ckpt"))
    state = Trainer(cfg, rec, device="cpu").fit(
        den, adam(2e-3), ConstantSigma(SIGMA), FixedBatches([tb], [tb])
    )
    assert state.step == 1 and spy.take() == {"K5": 3}
    logged = {k: v for step, m in rec.metrics for k, v in m.items() if step == 1}
    assert np.isfinite(logged["train/loss"]) and np.isfinite(logged["val/loss"])
    assert logged["train/grad_norm"] > 0


def test_walk_with_trainable_parameters_stays_on_the_tiled_kernel(monkeypatch):
    """`Sampler.sample` at N = 136 with a model whose parameters still ask for
    a gradient: the walk and the jump run with autograd off, so every
    denoiser call takes K5 (three blocks each) and none the plain path."""
    from jamun_tpu_torch.sampling.sampler import Sampler
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    spy = _Spy(monkeypatch)
    tb = make_test_batch(**BIG, device="cpu")
    model = E3Conv(**ARCH, device="cpu", seed=0)
    model.output_gain.data.fill_(1.0)
    assert all(p.requires_grad for p in model.parameters()) and torch.is_grad_enabled()
    den = Denoiser(model, DenoiserConfig(1.0, 0.3))
    cfg = MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=3, score_fn_clip=100.0)
    out = Sampler(device="cpu").sample(den, SingleMeasurementSampler(BAOAB(cfg), SIGMA), 1, tb, seed=2)
    assert spy.take() == {"K5": 3 * (3 + 1)}  # the initial score, two updates, the final jump
    assert all(np.isfinite(entry["sample"]).all() for entry in out[0])


def test_baoab_step_n136_matches_jax(big):
    """Two BAOAB steps at N = 136 with the same injected Gaussian draws and
    the real denoiser scores on both sides (JAX on kernel #5), as
    `test_torch_model.py` does at N = 8: y, v and both scores within 1e-4 of
    their max."""
    jdens, params, jb, den, tb = big
    jden = jdens["kernel"]
    cfg_kw = dict(delta=0.04, friction=1.0, M=1.0, steps=3, score_fn_clip=50.0)
    jcfg, cfg = JMCMCConfig(**cfg_kw), MCMCConfig(**cfg_kw)
    rng = np.random.default_rng(9)
    draws = [rng.standard_normal(jb.pos.shape).astype(np.float32) for _ in range(2)]
    it = iter(draws)
    jproc = j_processed(jax.jit(lambda y: jden.score(params, jb.replace_pos(y), SIGMA)), 1.0, 50.0)
    den.arch.requires_grad_(False)
    with torch.no_grad():
        tproc = make_processed_score_fn(lambda y: den.score(tb.replace_pos(y), SIGMA), 1.0, 50.0)
        v0 = torch.from_numpy(rng.standard_normal(jb.pos.shape).astype(np.float32))
        carry = (tb.pos, v0, *tproc(tb.pos))
        jpsi, jorig, _ = jproc(jnp.asarray(jb.pos))
        jcarry = (jnp.asarray(jb.pos), jnp.asarray(v0.numpy()), jpsi, jorig, None)
        sampler = BAOAB(cfg)
        damp, zeta2 = np.exp(-1.0), np.sqrt(1.0 - np.exp(-2.0))
        for R in draws:
            carry = sampler.step(carry, torch.from_numpy(R), tproc)
            jcarry = JBAOAB._step(
                jcarry, None, jproc, jcfg, damp, zeta2, 1.0, lambda k, s, d: jnp.asarray(next(it))
            )
            for a, b in zip(carry, jcarry[:4]):
                assert _rel(a.numpy(), np.asarray(b)) < 1e-4


def test_score_equivariance_n136(big):
    """score(R y + t) = R score(y) - t / sigma^2 at N = 136 on the K5 path."""
    _, _, _, den, tb = big
    q, r = np.linalg.qr(np.random.default_rng(3).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    R = torch.from_numpy((q if np.linalg.det(q) > 0 else -q).astype(np.float32))
    shift = torch.tensor([0.3, -0.2, 0.5])
    mask = tb.node_mask[..., None].float()
    den.arch.requires_grad_(False)
    with torch.no_grad():
        s = den.score(tb, SIGMA)
        s_rot = den.score(tb.replace_pos((tb.pos @ R.T + shift) * mask), SIGMA)
    err = (s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()
    assert float(err) < 1e-4
