"""The whole-model stack path of the port against JAX (CPU, f32) and against
the port's own layerwise path.

JAX side: `packed_e3conv_stack(interpret=True)` and
`E3Conv(use_pallas=True, fused_stack=True)`, as `tests/test_e3_stack.py` runs
them on the CPU. Port side: `e3conv_stack_plain`, the kernel's plain twin,
which is what `E3Conv(fused_stack=True)` reaches for CPU tensors. Inputs and
weights come from numpy seeds and cross over with `from_jax_params`;
`output_gain` is perturbed away from zero like every other leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.pallas.e3_stack import packed_e3conv_stack
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv, irreps_to_vector
from jamun_tpu_torch.ops.cuda import e3_stack as k3
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
ARCH = dict(tensor_product="uvu", n_layers=2, irreps_hidden="32x0e + 16x1e")
BATCH = dict(num_graphs=2, max_nodes=16, nodes_per_graph=[14, 16], scale=0.3)
C_NOISE = float(np.log(0.04) / 4.0)


def _params(jmodel, jb, seed):
    """flax init, every leaf perturbed with seeded numpy noise."""
    params = jmodel.init(jax.random.PRNGKey(seed), jb, jnp.asarray([C_NOISE]), jnp.asarray(1.0))
    rng = np.random.default_rng(200 + seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )


def _pair(arch=ARCH, batch=BATCH, seed=0, dtype=None, **torch_kw):
    """(JAX stack model, params, JAX batch, port stack model, port batch)."""
    jb, tb = j_make_test_batch(**batch), make_test_batch(**batch, device="cpu")
    jmodel = JE3Conv(**arch, use_pallas=True, fused_stack=True)
    params = _params(jmodel, jb, seed)
    model = E3Conv(**arch, fused_stack=True, dtype=dtype, device="cpu", **torch_kw)
    model.load_state_dict(from_jax_params(params), strict=True)
    model.requires_grad_(False)
    return jmodel, params, jb, model, tb


def _layerwise(model, arch=ARCH, dtype=None, **kw):
    twin = E3Conv(**arch, dtype=dtype, device="cpu", **kw)
    twin.load_state_dict(model.state_dict(), strict=True)
    return twin.requires_grad_(False)


def _c_noise():
    return torch.tensor([C_NOISE], dtype=torch.float32)


def test_stack_plain_matches_jax_kernel():
    """`e3conv_stack_plain` against `packed_e3conv_stack(interpret=True)` on
    the same positions, embedding, scales, skip weights and weights (f32,
    the JAX stack test's own tolerance)."""
    _, params, jb, model, tb = _pair()
    S, V, S_emb, L = 32, 16, 56, 2
    rng = np.random.default_rng(7)
    nf0 = rng.standard_normal((2, 16, S_emb)).astype(np.float32)
    scales = (1.0 + 0.3 * rng.standard_normal((L, S + V))).astype(np.float32)
    skipw = rng.uniform(0.2, 0.8, (L, S + V)).astype(np.float32)

    p = params["params"]

    def block_w(q):
        cp, rp = q["Conv_0"], q["Conv_0"]["radial_nn"]
        return (rp["Dense_0"]["kernel"], rp["Dense_0"]["bias"], rp["Dense_1"]["kernel"],
                rp["Dense_1"]["bias"], dict(cp["_post_linear"]), dict(q["IrrepsLinear_1"]),
                dict(q["IrrepsLinear_0"]))

    layers = [block_w(p[f"_HiddenLayer_{i}"]["ConvBlock_0"]) for i in range(L)]
    want = packed_e3conv_stack(
        jnp.asarray(jb.pos), jb.node_mask, jb.bond_src, jb.bond_dst, jb.bond_mask > 0,
        jnp.asarray(0.9), jnp.asarray(nf0), block_w(p["ConvBlock_0"]),
        jax.tree.map(lambda *xs: jnp.stack(xs), *layers), jnp.asarray(scales), jnp.asarray(skipw),
        dict(p["EquivariantMLP_0"]["EquivariantMLPBlock_0"]["IrrepsLinear_0"]),
        dict(p["EquivariantMLP_0"]["IrrepsLinear_0"]),
        jnp.asarray(p["embed_bondedness"][0]), jnp.asarray(p["embed_bondedness"][1]),
        ((1, 1),), S=S, V=V, S_emb=S_emb, interpret=True,
    )
    with torch.no_grad():
        proj_w, layers_w, head_w = model._stack_weights(torch.float32)
        assert layers_w.w2.shape == (L, 64, 2 * S + 3 * V)
        got = k3.e3conv_stack(
            tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, 0.9,
            torch.from_numpy(nf0), proj_w, layers_w, torch.from_numpy(scales),
            torch.from_numpy(skipw), head_w,
        )
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * np.abs(want).max(), rtol=1e-4)


CASES = {
    "two_sizes": (ARCH, BATCH),
    "odd_n17": (dict(ARCH, n_layers=1), dict(num_graphs=1, max_nodes=17, nodes_per_graph=[17], scale=0.3)),
    "unaligned_widths_two_outputs": (
        dict(tensor_product="uvu", n_layers=1, irreps_hidden="40x0e + 16x1e",
             irreps_out="1x0e + 1x1e"),
        dict(num_graphs=1, max_nodes=16, scale=0.3),
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_stack_matches_jax(case):
    """The port's `E3Conv(fused_stack=True)` against JAX's stack path: two
    graph sizes in one batch, odd N = 17, and widths off the 16-multiples
    with a scalar and a vector output block."""
    arch, batch = CASES[case]
    jmodel, params, jb, model, tb = _pair(arch, batch, seed=1)
    assert model._stack_ok(tb, _c_noise())
    want = np.asarray(jax.jit(jmodel.apply)(params, jb, jnp.asarray([C_NOISE]), jnp.asarray(1.0)))
    with torch.no_grad():
        got = model(tb, _c_noise(), 1.0).numpy()
    assert np.abs(want).max() > 1e-2
    # f32 on both sides, different summation orders; held relative to the
    # output's size (the perturbed weights give outputs far from 1)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=1e-4)


def test_fused_stack_denoiser_score_matches_jax():
    """`Denoiser.score` under no_grad takes the stack and agrees with JAX's
    stack denoiser."""
    jmodel, _, jb, model, tb = _pair()
    jden = JDenoiser(jmodel, JConfig(max_radius=1.0, average_squared_distance=0.5))
    dp = jden.init(jax.random.PRNGKey(1), jb)
    rng = np.random.default_rng(11)
    dp = jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), dp
    )
    model.load_state_dict(from_jax_params(dp), strict=True)
    den = Denoiser(model, DenoiserConfig(max_radius=1.0, average_squared_distance=0.5))
    taken = []
    inner = model._stack_args
    model._stack_args = lambda *a: taken.append(1) or inner(*a)
    with torch.no_grad():
        got = den.score(tb, 0.05).numpy()
    assert taken == [1]
    want = np.asarray(jax.jit(lambda p, b: jden.score(p, b, 0.05))(dp, jb))
    assert np.abs(want).max() > 1.0
    # the score is (xhat - y) / sigma^2: xhat's f32 error times 400
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(), rtol=1e-4)


@pytest.mark.parametrize("cdt,tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("irreps_out", ["1x1e", "2x1e + 3x0e"])
def test_stack_matches_layerwise_port(cdt, tol, irreps_out):
    """Port stack against port layerwise on the same weights. f32: the same
    arithmetic up to summation order (1e-5 of the output's max). bf16: the
    stack carries x in f32 between layers and rounds the head's products
    once, where the layerwise path rounds x per layer and every head product
    to bf16: a few bf16 steps (2^-8 each), held to 4e-2 of the max."""
    arch = dict(ARCH, irreps_out=irreps_out)
    _, _, _, model, tb = _pair(arch, seed=2, dtype=cdt)
    base = _layerwise(model, arch, dtype=cdt)
    with torch.no_grad():
        got, want = model(tb, _c_noise(), 1.0), base(tb, _c_noise(), 1.0)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert float(want.abs().max()) > 1e-2
    assert float((got - want).abs().max() / want.abs().max()) < tol


def test_stack_gate_dispatch():
    """What JAX's gate sends to the layerwise path does so here: an odd
    output parity, two noise levels, N > 64; the result is the layerwise
    model's."""
    c1 = _c_noise()
    _, _, _, model, tb = _pair()
    assert model._stack_ok(tb, c1)
    two = torch.tensor([C_NOISE, 0.1])
    assert not model._stack_ok(tb, two)
    with torch.no_grad():
        torch.testing.assert_close(model(tb, two, 1.0), _layerwise(model)(tb, two, 1.0), rtol=0, atol=0)

    odd = E3Conv(**ARCH, irreps_out="1x1o", fused_stack=True, device="cpu", seed=0)
    odd.requires_grad_(False).output_gain.fill_(0.7)
    assert not odd._stack_ok(tb, c1)
    with torch.no_grad():
        out = odd(tb, c1, 1.0)
        want = _layerwise(odd, dict(ARCH, irreps_out="1x1o"))(tb, c1, 1.0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, rtol=0, atol=0)

    big = make_test_batch(num_graphs=1, max_nodes=65, max_bonds=130, scale=0.5, device="cpu")
    small_arch = dict(tensor_product="uvu", n_layers=1, irreps_hidden="8x0e + 4x1e")
    wide = E3Conv(**small_arch, fused_stack=True, device="cpu", seed=0).requires_grad_(False)
    wide.output_gain.fill_(0.7)
    assert not wide._stack_ok(big, c1)
    assert wide._stack_ok(make_test_batch(num_graphs=1, max_nodes=64, device="cpu"), c1)
    with torch.no_grad():
        torch.testing.assert_close(
            wide(big, c1, 1.5), _layerwise(wide, small_arch)(big, c1, 1.5), rtol=0, atol=0
        )


def test_stack_bypassed_under_autograd():
    """With a gradient wanted the stack model runs the layerwise path
    (forward K2, backward K4): same loss, same gradients, bit for bit."""
    _, _, _, model, tb = _pair(seed=3)
    base = _layerwise(model)
    grads = []
    for m in (model, base):
        m.requires_grad_(True)
        assert not m._stack_ok(tb, _c_noise())
        m(tb, _c_noise(), 1.0).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    assert len(grads[0]) == len(grads[1]) > 40
    for name, g in grads[1].items():
        torch.testing.assert_close(grads[0][name], g, rtol=0, atol=0, msg=name)
    # and without one it is back on the stack
    with torch.no_grad():
        assert model._stack_ok(tb, _c_noise())


def test_stack_needs_no_new_parameter():
    """`fused_stack` changes no parameter: the state dict of the stack model
    is the layerwise model's, key for key, and `from_jax_params` fills it."""
    _, params, _, model, _ = _pair()
    base = E3Conv(**ARCH, device="cpu")
    assert list(model.state_dict()) == list(base.state_dict())
    assert set(from_jax_params(params)) == set(base.state_dict())
    assert [tuple(v.shape) for v in model.state_dict().values()] == [
        tuple(v.shape) for v in base.state_dict().values()
    ]


def test_stack_supported_and_wrapper_checks():
    even = ((1, 1, 1),)
    assert k3.stack_supported(64, 120, 32, 56, even)
    assert k3.stack_supported(19, 120, 1, 56, even)  # no Mosaic V >= 16 rule
    assert not k3.stack_supported(65, 120, 32, 56, even)
    assert not k3.stack_supported(44, 120, 0, 56, even)
    assert not k3.stack_supported(44, 150, 32, 56, even)  # 2S + 3V > 384 threads
    assert not k3.stack_supported(44, 120, 32, 200, even)
    assert not k3.stack_supported(44, 120, 32, 56, ((1, 1, -1),))
    assert not k3.stack_supported(44, 120, 32, 56, ((1, 2, 1),))
    out = torch.arange(2 * 11, dtype=torch.float32).reshape(2, 11)  # 2 scalars, 3 vectors
    re = k3._reassemble(out, ((2, 1), (2, 0), (1, 1)))
    assert re[0].tolist() == [2, 3, 4, 5, 6, 7, 0, 1, 8, 9, 10]
    assert k3._reassemble(out, ((2, 0), (3, 1))) is out


def test_score_builds_no_tensor_from_the_host(monkeypatch):
    """Nothing in `Denoiser.score` makes a tensor from host data (an index
    list, a Python scalar turned into a tensor): on the card each such copy
    waits for every kernel queued before it, and the walk's host could not
    run ahead of the device. `irreps_to_vector` once indexed with a list."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    f = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    with Record():
        out = irreps_to_vector(f)
    torch.testing.assert_close(out, f[..., [2, 0, 1]], rtol=0, atol=0)
    assert "index" not in ops and "lift_fresh" not in ops, ops

    # everything around the kernel's wrapper (on the CPU the wrapper runs the
    # plain version, which is free to make such tensors; on the card it
    # launches the kernel and makes none)
    tb = make_test_batch(**BATCH, device="cpu")
    model = E3Conv(**ARCH, fused_stack=True, device="cpu", seed=0).requires_grad_(False)
    monkeypatch.setattr(k3, "e3conv_stack", lambda pos, *a: pos.new_zeros(pos.shape))
    den = Denoiser(model, DenoiserConfig(max_radius=1.0, average_squared_distance=0.5))
    with torch.no_grad():
        den.score(tb, 0.05)  # the first call makes the cached divisors (`rounded_divisor`)
    ops.clear()
    with torch.no_grad(), Record():
        den.score(tb, 0.05)
    assert len(ops) > 100
    # (`index` itself is the embedding lookup, by index tensors of the batch)
    assert not {"lift_fresh", "scalar_tensor", "_local_scalar_dense"} & set(ops), ops
    assert ops.count("index") == 4
