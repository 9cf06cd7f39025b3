"""K5 under a gradient: the port's trainable tiled block against JAX's
`make_trainable_conv_block_v2` (CPU, f32), and `E3Conv(tiled_kernel_training=
True)`'s training dispatch against JAX's.

JAX side: `make_trainable_conv_block_v2(interpret=True)`, as
`tests/test_pallas_conv.py` runs the Pallas kernels on the CPU: its forward
is `packed_fused_block_v2` in interpret mode, its backward above 128 atoms
the VJP of the same body with `xla_reference=True`, at or below 128 atoms
`_edge_features_pallas` and `packed_conv_block_bwd`, both in interpret mode.
Port side: `ConvBlock.fused` on a `TiledGeometry` with autograd on, which
takes `fused_block_tiled_trainable` (on the CPU K5's plain twin forward; the
backward recomputes the twin under autograd above 128 atoms, and takes K1's
and K4's twins at or below). Inputs, weights and cotangents come from numpy
seeds and cross over with `from_jax_params`. Each tolerance is written
beside its check, relative to the reference's largest value. The card's
half (K5 forward under autograd, against the same block on the CPU) is
`tests/test_torch_cuda.py::test_trainable_tiled_block_matches_cpu`, in the
file that runs on a machine without JAX; it skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.conv import ConvBlock as JConvBlock
from jamun_tpu.ops.graph import EdgeData
from jamun_tpu.ops.pallas import packed_conv as jpk
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops import conv as port_conv
from jamun_tpu_torch.ops.conv import ConvBlock
from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
CUTOFF = 0.9
SH = "1x0e + 1x1e"
OUT = "16x0e + 8x1e"
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")
BIG = dict(num_graphs=2, max_nodes=136, nodes_per_graph=[136, 131], max_bonds=272, scale=0.6)
SMALL = dict(num_graphs=2, max_nodes=32, nodes_per_graph=[29, 32], max_bonds=64, scale=0.5)
# the JAX VJP's weight arguments, in `make_trainable_conv_block_v2`'s order,
# each with its leaf (or subtree) in the ConvBlock's parameters
W_ARGS = ("w1", "b1", "w2", "b2", "bond0", "bond1", "plp", "l2p", "skp")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturbed(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32)),
        tree,
    )


def _block(irreps_in, batch_kw, seed=21):
    """A JAX ConvBlock's perturbed params, the same block in the port, both
    batches, an input, the bondedness embeddings and a cotangent."""
    jb, tb = j_make_test_batch(**batch_kw), make_test_batch(**batch_kw, device="cpu")
    G, N, B = jb.pos.shape[0], jb.pos.shape[1], jb.bond_src.shape[1]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, N, Irreps(irreps_in).dim)).astype(np.float32)
    bond = rng.standard_normal((2, 32)).astype(np.float32)
    cot = rng.standard_normal((G, N, Irreps(OUT).dim)).astype(np.float32)
    jm = JConvBlock(irreps_in, OUT, SH, 64, tensor_product="uvu")
    z = jnp.zeros
    dummy = EdgeData(
        sh_dense=z((G, 8, 8, 4)), attr_dense=z((G, 8, 8, 64)), adj=z((G, 8, 8)),
        sh_bond=z((G, B, 4)), attr_bond=z((G, B, 64)), bond_src=z((G, B), jnp.int32),
        bond_dst=z((G, B), jnp.int32), bond_mask=z((G, B)),
    )
    p = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :8]), dummy), seed + 1, 0.1)
    tm = ConvBlock(irreps_in, OUT, SH, 64)
    tm.load_state_dict(from_jax_params(p), strict=True)
    return jb, tb, p["params"], tm, x, bond, cot


def _jax_vjp(irreps_in, jb, pp, x, bond, cot):
    """JAX's trainable tiled block: its output and the VJP of `cot` with
    respect to x and every weight argument ({name: array or subtree})."""
    S, V = Irreps(irreps_in).sv_shape()
    f = jpk.make_trainable_conv_block_v2(S, V, ((16, 0), (8, 0), (8, 1)), 32, True, None)
    posm, bf, ebsT, ebd = jpk.packed_geometry_inputs(
        jb.pos, jb.node_mask, jb.bond_src, jb.bond_dst, jb.bond_mask, jnp.asarray(CUTOFF), n_radial=32
    )
    rp = pp["Conv_0"]["radial_nn"]
    weights = (
        rp["Dense_0"]["kernel"], rp["Dense_0"]["bias"], rp["Dense_1"]["kernel"], rp["Dense_1"]["bias"],
        jnp.asarray(bond[0]), jnp.asarray(bond[1]), dict(pp["Conv_0"]["_post_linear"]),
        dict(pp["IrrepsLinear_1"]), dict(pp["IrrepsLinear_0"]),
    )

    def run(x, *w):
        return f(x, posm, bf, ebsT, ebd, *w, jnp.asarray(CUTOFF))

    out, vjp = jax.vjp(run, jnp.asarray(x), *weights)
    dx, *dw = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(dx), dict(zip(W_ARGS, dw))


def _port_grads(tm, tb, x, bond, cot, monkeypatch):
    """The port's block through `ConvBlock.fused` with autograd on: its
    output and the gradients of <out, cot>, keyed like `_jax_vjp`'s."""
    used = []
    inner = port_conv.fused_block_tiled_trainable
    monkeypatch.setattr(port_conv, "fused_block_tiled_trainable",
                        lambda *a, **k: used.append(1) or inner(*a, **k))
    tm.zero_grad()
    xt = torch.from_numpy(x).requires_grad_(True)
    b0, b1 = (torch.from_numpy(b.copy()).requires_grad_(True) for b in bond)
    geo = k5.tiled_geometry_inputs(tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, CUTOFF)
    out = tm.fused(xt, geo, b0, b1)
    (out * torch.from_numpy(cot)).sum().backward()
    assert used == [1]  # the trainable tiled block, not the plain path
    conv = tm.Conv_0
    g = lambda p: p.grad.numpy()  # noqa: E731
    lin = lambda m: {k: g(v) for k, v in m.named_parameters()}  # noqa: E731
    return out.detach().numpy(), xt.grad.numpy(), {
        "w1": g(conv.radial_nn.Dense_0.kernel), "b1": g(conv.radial_nn.Dense_0.bias),
        "w2": g(conv.radial_nn.Dense_1.kernel), "b2": g(conv.radial_nn.Dense_1.bias),
        "bond0": b0.grad.numpy(), "bond1": b1.grad.numpy(),
        "plp": lin(conv._post_linear), "l2p": lin(tm.IrrepsLinear_1), "skp": lin(tm.IrrepsLinear_0),
    }


@pytest.mark.parametrize("irreps_in", ["16x0e + 8x1e", "24x0e"], ids=["hidden", "projector"])
@pytest.mark.parametrize("shape", ["n136_recompute", "n32_k4"])
def test_trainable_tiled_block_matches_jax(shape, irreps_in, monkeypatch):
    """Output and every gradient of the trainable tiled block against JAX's,
    f32: at N = 136 JAX's backward differentiates the XLA body and the port
    its plain twin; at N = 32 both rebuild the edge features and run the
    ConvBlock backward (JAX's kernel #4 in interpret mode, the port's K4
    twin on K2's residuals). The hidden block (V > 0) and the projector
    (V = 0). Output 1e-5 of its max; gradients 1e-4 of each leaf's max."""
    batch_kw = BIG if shape == "n136_recompute" else SMALL
    jb, tb, pp, tm, x, bond, cot = _block(irreps_in, batch_kw)
    want_out, want_dx, want_w = _jax_vjp(irreps_in, jb, pp, x, bond, cot)
    got_out, got_dx, got_w = _port_grads(tm, tb, x, bond, cot, monkeypatch)
    assert np.abs(want_out).max() > 0.1
    assert _rel(got_out, want_out) < 1e-5
    assert _rel(got_dx, want_dx) < 1e-4
    n_checked = 0
    for name, want in want_w.items():
        pairs = [(got_w[name], want)] if not isinstance(want, dict) else [
            (got_w[name][k], v) for k, v in want.items()
        ]
        if isinstance(want, dict):
            assert sorted(got_w[name]) == sorted(want), name
        for got, w in pairs:
            w = np.asarray(w)
            assert got.shape == w.shape, name
            if np.abs(w).max() > 0:
                assert _rel(got, w) < 1e-4, (name, _rel(got, w))
                n_checked += 1
    assert n_checked >= (15 if irreps_in == "16x0e + 8x1e" else 11)


def test_geometry_gets_no_gradient_and_positions_refuse(monkeypatch):
    """The geometry is no input of the gradient (JAX returns zeros for it):
    the backward returns none for it; a position that asks for one raises,
    as `packed_geometry_inputs` refuses it."""
    _, tb, _, tm, x, bond, _ = _block("16x0e + 8x1e", SMALL)
    geo = k5.tiled_geometry_inputs(tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, CUTOFF)
    out = tm.fused(torch.from_numpy(x).requires_grad_(True), geo, *map(torch.from_numpy, bond))
    out.sum().backward()
    assert geo.pos.grad is None
    pos = tb.pos.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Position gradients through the kernels"):
        k5.fused_block_tiled_trainable(
            torch.from_numpy(x), k5.TiledGeometry(pos, *geo[1:]), None
        )


def _models(tiled_kernel_training, seed=1):
    config = dict(max_radius=1.0, average_squared_distance=0.3, add_fixed_ones=True)
    jb, tb = j_make_test_batch(**BIG), make_test_batch(**BIG, device="cpu")
    jden = JDenoiser(
        JE3Conv(**ARCH, use_pallas=True, neighbor_mode="dense", tiled_kernel_training=tiled_kernel_training),
        JConfig(**config),
    )
    small = j_make_test_batch(num_graphs=1, max_nodes=8)
    params = _perturbed(jden.init(jax.random.PRNGKey(seed), small), 300 + seed, 0.3)
    arch = E3Conv(**ARCH, neighbor_mode="dense", tiled_kernel_training=tiled_kernel_training, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    return jden, params, jb, Denoiser(arch, DenoiserConfig(**config)), tb


def test_training_loss_with_tiled_kernel_training_matches_jax(monkeypatch):
    """`training_loss` and its gradients at N = 136 with
    `tiled_kernel_training=True` on both sides: JAX's differentiated call
    takes its trainable tiled block (kernel #5 in interpret mode, three
    blocks), the port's takes `fused_block_tiled_trainable` three times and
    the plain path never. The same noise through `add_fixed_ones`. Loss 1e-5
    relative; gradients 1e-4 of each leaf's max."""
    made, used = [], []
    inner_j = jpk.make_trainable_conv_block_v2
    monkeypatch.setattr(jpk, "make_trainable_conv_block_v2", lambda *a, **k: made.append(1) or inner_j(*a, **k))
    inner_t = port_conv.fused_block_tiled_trainable
    monkeypatch.setattr(port_conv, "fused_block_tiled_trainable",
                        lambda *a, **k: used.append(1) or inner_t(*a, **k))
    jden, params, jb, den, tb = _models(True)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jden.training_loss, has_aux=True))(
        params, jax.random.PRNGKey(0), jb, SIGMA
    )
    assert len(made) == 3
    loss, _ = den.training_loss(tb, SIGMA, torch.Generator())
    loss.backward()
    assert len(used) == 3
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


@pytest.mark.parametrize("flag", [False, True], ids=["off", "on"])
def test_dispatch_flag(flag, monkeypatch):
    """Which way a call that wants a gradient above 128 atoms goes: the
    plain path when the flag is off (JAX's default), the trainable tiled
    block when it is on; a call without a gradient takes K5 either way; at
    or below 128 atoms the flag changes nothing (K2 with K4)."""
    calls = {"trainable": 0, "K5": 0, "K2+K4": 0}
    for name, attr in (("trainable", "fused_block_tiled_trainable"), ("K5", "fused_block_tiled"),
                       ("K2+K4", "conv_block_trainable")):
        inner = getattr(port_conv, attr)

        def counted(*a, _name=name, _inner=inner, **k):
            calls[_name] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(port_conv, attr, counted)
    model = E3Conv(**ARCH, neighbor_mode="dense", tiled_kernel_training=flag, device="cpu", seed=0)
    c = torch.tensor([-0.8])

    def run(kw, grad):
        for k in calls:
            calls[k] = 0
        batch = make_test_batch(**kw, device="cpu")
        with torch.set_grad_enabled(grad):
            model(batch, c, 1.0)
        return {k: v for k, v in calls.items() if v}

    assert run(BIG, True) == ({"trainable": 3} if flag else {})
    assert run(BIG, False) == {"K5": 3}
    assert run(SMALL, True) == {"K2+K4": 3}
