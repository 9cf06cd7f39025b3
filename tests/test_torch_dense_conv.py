"""The Conv-level dense kernels against JAX (CPU, f32): K8's and K9's plain
twins against `packed_uvu_conv_dense` / `fused_uvu_conv_dense`, K2's layer
mode against `packed_separable_conv_layer(fuse_block=False)`, the port's
`Conv` dispatch against JAX `Conv(use_pallas=True, pallas_variant=...)`
(which way each call goes on both sides), and `E3Conv(pallas_variant=
"plane")` against JAX's XLA path, with one equivariance check.

The JAX kernels run in interpret mode, as `tests/test_pallas_conv.py` runs
them on the CPU. Inputs and weights come from numpy seeds; module
parameters from JAX `init`, perturbed with seeded noise, loaded through
`params.from_jax_params`. Tolerances: the twins and the kernels compute the
same f32 function in another summation order, so 1e-5 of the output's max,
the degree exactly; whole models 1e-4 of the max (five layers of such
differences).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jamun_tpu.ops.pallas.fused_conv as j_fused
import jamun_tpu.ops.pallas.packed_conv as j_packed
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.conv import Conv as JConv
from jamun_tpu.ops.graph import dense_edge_data as j_dense_edge_data
from jamun_tpu.ops.radial import soft_one_hot_linspace as j_radial
from jamun_tpu.ops.sh import spherical_harmonics as j_sh
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops import conv as conv_mod
from jamun_tpu_torch.ops.conv import Conv
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import dense_conv as k89
from jamun_tpu_torch.ops.cuda.edge_features import edge_features
from jamun_tpu_torch.ops.graph import dense_edge_data
from jamun_tpu_torch.ops.radial import soft_one_hot_linspace
from jamun_tpu_torch.ops.sh import spherical_harmonics
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SH = "1x0e + 1x1e"
CUTOFF = 0.8
G, N, NODES = 2, 16, [14, 16]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _perturb(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def _batches(n=N, nodes=NODES):
    kw = dict(num_graphs=len(nodes), max_nodes=n, nodes_per_graph=list(nodes), scale=0.3)
    return j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")


def _kernel_inputs(S, V, seed):
    """pos, mask, x and the radial MLP's weights as numpy (the JAX signature)."""
    jb, _ = _batches()
    rng = np.random.default_rng(seed)
    W = 2 * S + 3 * V
    return dict(
        pos=np.asarray(jb.pos), node_mask=np.asarray(jb.node_mask),
        x=rng.standard_normal((G, N, S + 3 * V)).astype(np.float32),
        w1=(rng.standard_normal((64, 64)) / 8).astype(np.float32),
        b1=(0.1 * rng.standard_normal(64)).astype(np.float32),
        w2=(rng.standard_normal((64, W)) / 8).astype(np.float32),
        b2=(0.1 * rng.standard_normal(W)).astype(np.float32),
        bond0=rng.standard_normal(32).astype(np.float32),
    )


def _args(a: dict, lib) -> tuple:
    conv = jnp.asarray if lib is jnp else torch.from_numpy
    keys = ("pos", "node_mask", "x", "w1", "b1", "w2", "b2", "bond0")
    return tuple(conv(a[k]) for k in keys) + (CUTOFF,)


@pytest.mark.parametrize(
    "kernel,S,V",
    [("packed_uvu_conv_dense", 24, 8), ("packed_uvu_conv_dense", 24, 0), ("fused_uvu_conv_dense", 24, 8)],
)
def test_dense_twins_match_jax(kernel, S, V):
    """K8's twin (V = 8 and V = 0) and K9's twin against JAX's kernels in
    interpret mode; the wrapper on CPU tensors is the twin."""
    a = _kernel_inputs(S, V, seed=S + V)
    jfn = {"packed_uvu_conv_dense": j_packed, "fused_uvu_conv_dense": j_fused}[kernel]
    want, want_deg = map(np.asarray, getattr(jfn, kernel)(*_args(a, jnp), S=S, V=V, interpret=True))
    got, deg = getattr(k89, f"{kernel}_plain")(*_args(a, torch), S, V)
    assert got.shape == (G, N, 4 * S + 7 * V) == want.shape
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    assert 0 < deg.sum() < sum(n * (n - 1) for n in NODES)  # pairs on both sides of the cutoff
    got_w, deg_w = getattr(k89, kernel)(*_args(a, torch), S, V)
    assert torch.equal(got_w, got) and torch.equal(deg_w, deg)


def test_fused_twin_refuses_v0():
    a = _kernel_inputs(24, 0, seed=3)
    for fn in (k89.fused_uvu_conv_dense, k89.fused_uvu_conv_dense_plain):
        with pytest.raises(ValueError, match="V = 0"):
            fn(*_args(a, torch), 24, 0)


def test_k8_and_k9_twins_agree_bit_for_bit():
    a = _kernel_inputs(16, 8, seed=5)
    got8 = k89.packed_uvu_conv_dense(*_args(a, torch), 16, 8)
    got9 = k89.fused_uvu_conv_dense(*_args(a, torch), 16, 8)
    assert all(torch.equal(p, q) for p, q in zip(got8, got9))


# ---- Conv level ----


def _edges(rng, bond1: bool):
    """JAX's and the port's EdgeData on one batch, both with the raw fields
    and the bondedness rows (bond1 None when `bond1` is False)."""
    jb, tb = _batches()
    emb = rng.standard_normal((2, 32)).astype(np.float32)

    def j_attr(dist, bonded):
        r = j_radial(dist, 0.0, CUTOFF, 32, basis="gaussian", cutoff=True)
        return jnp.concatenate([jnp.broadcast_to(emb[int(bonded)], dist.shape + (32,)), r], -1)

    def t_attr(dist, bonded):
        r = soft_one_hot_linspace(dist, 0.0, CUTOFF, 32)
        return torch.cat([torch.from_numpy(emb[int(bonded)]).expand(dist.shape + (32,)), r], -1)

    je = j_dense_edge_data(
        jb.pos, jb.node_mask, jb.bond_src, jb.bond_dst, jb.bond_mask, jnp.asarray(CUTOFF),
        functools.partial(j_sh, SH), j_attr, dense=True, bond0_embed=jnp.asarray(emb[0]),
        bond1_embed=jnp.asarray(emb[1]) if bond1 else None,
    )
    te = dense_edge_data(
        tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, CUTOFF,
        functools.partial(spherical_harmonics, SH), t_attr, bond0_embed=torch.from_numpy(emb[0]),
        bond1_embed=torch.from_numpy(emb[1]) if bond1 else None,
    )
    return je, te


class Spy:
    """Counts the calls of named module attributes, and still calls them."""

    def __init__(self, monkeypatch, module, names):
        self.calls = []
        for name in names:
            fn = getattr(module, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.calls.append(_name)
                return _fn(*a, **k)

            monkeypatch.setattr(module, name, wrapped)


JAX_KERNELS = ("packed_uvu_conv_dense", "packed_separable_conv_layer")
PORT_ROUTES = ("conv_layer", "packed_uvu_conv_dense", "fused_uvu_conv_dense", "fast_uvu_messages_dense")


def _conv_pair(monkeypatch, variant, irreps_in, irreps_out, bond1, seed):
    """(JAX out, port out, JAX kernels called, port routes called)."""
    rng = np.random.default_rng(seed)
    je, te = _edges(rng, bond1)
    from jamun_tpu.ops.irreps import Irreps

    x = rng.standard_normal((G, N, Irreps(irreps_in).dim)).astype(np.float32)
    kw = dict(irreps_in=irreps_in, irreps_out=irreps_out, irreps_sh=SH, edge_attr_dim=64,
              tensor_product="uvu")
    jref = JConv(**kw, use_pallas=False)
    params = _perturb(jref.init(jax.random.PRNGKey(seed), jnp.asarray(x), je), seed)
    jspy = Spy(monkeypatch, j_packed, JAX_KERNELS)
    jspy9 = Spy(monkeypatch, j_fused, ("fused_uvu_conv_dense",))
    jpal = JConv(**kw, use_pallas=True, pallas_variant=variant)
    want = np.asarray(jax.jit(jpal.apply)(params, jnp.asarray(x), je))
    port = Conv(irreps_in, irreps_out, SH, 64, pallas_variant=variant)
    port.load_state_dict(from_jax_params(params), strict=True)
    port.requires_grad_(False)
    pspy = Spy(monkeypatch, conv_mod, PORT_ROUTES)
    got = port(torch.from_numpy(x), te, kernel=True).numpy()
    return want, got, jspy.calls + jspy9.calls, pspy.calls, port, te


@pytest.mark.parametrize(
    "variant,irreps_in,irreps_out,bond1,jax_kernel,route",
    [
        # the fused layer applies: K2's layer mode
        ("packed", "24x0e + 8x1e", "16x0e + 8x1e", True, "packed_separable_conv_layer", "conv_layer"),
        # no 0e output block: K8
        ("packed", "24x0e + 8x1e", "8x1e", True, "packed_uvu_conv_dense", "packed_uvu_conv_dense"),
        # V = 0 (the projector's input): K8
        ("packed", "24x0e", "16x0e + 8x1e", False, "packed_uvu_conv_dense", "packed_uvu_conv_dense"),
        # no bondedness-1 row: K8
        ("packed", "24x0e + 8x1e", "16x0e + 8x1e", False, "packed_uvu_conv_dense",
         "packed_uvu_conv_dense"),
        # "plane": K9
        ("plane", "24x0e + 8x1e", "16x0e + 8x1e", True, "fused_uvu_conv_dense", "fused_uvu_conv_dense"),
        # "plane" at V = 0: XLA in JAX, the plain path in the port
        ("plane", "24x0e", "16x0e + 8x1e", True, None, "fast_uvu_messages_dense"),
    ],
)
def test_conv_matches_jax(monkeypatch, variant, irreps_in, irreps_out, bond1, jax_kernel, route):
    """The port's `Conv(kernel=True)` against JAX's `Conv(use_pallas=True)`:
    the same output, and each side takes the kernel the other takes."""
    want, got, jax_calls, port_calls, _, _ = _conv_pair(
        monkeypatch, variant, irreps_in, irreps_out, bond1, seed=len(irreps_out) + bond1
    )
    assert jax_calls == ([jax_kernel] if jax_kernel else [])
    assert port_calls == [route]
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def test_conv_layer_twin_matches_jax(monkeypatch):
    """K2's layer mode: its twin on K1's features (held in `EdgeData` or made
    by `Conv`) against JAX's `packed_separable_conv_layer(fuse_block=False)`
    (through JAX's `Conv(use_pallas=True)`), and the wrapper on CPU tensors
    is the twin."""
    want, got, jax_calls, _, port, te = _conv_pair(
        monkeypatch, "packed", "24x0e + 8x1e", "16x0e + 8x1e", True, seed=11
    )
    assert jax_calls == ["packed_separable_conv_layer"]
    assert _rel(got, want) < 1e-5
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((G, N, 48)).astype(np.float32))
    ef, bf = edge_features(te.pos, te.node_mask, te.bond_src, te.bond_dst, te.bond_mask > 0, CUTOFF)
    w = k2.layer_weights(port.radial_nn, port._post_linear, te.bond0_embed, te.bond1_embed,
                         S=24, V=8, cdt=torch.float32)
    twin = k2.conv_layer_plain(x, ef, bf, te.bond_src, te.bond_dst, w)
    assert torch.equal(k2.conv_layer(x, ef, bf, te.bond_src, te.bond_dst, w), twin)
    import dataclasses

    held = dataclasses.replace(te, pair_features=(ef, bf))
    with torch.no_grad():
        assert torch.equal(port(x, held, kernel=True), twin)
        assert torch.equal(port(x, te, kernel=True), twin)


def test_layer_columns_in_irreps_order():
    """The column map of K2's layer mode for a mixed irreps_out."""
    blocks = ((3, 0), (2, 1), (1, 0), (1, 1))
    assert k2._out_columns_list(blocks) == [0, 1, 2, 9, 3, 6, 10]


@pytest.mark.parametrize(
    "case,route",
    [
        ("grad", "plain"),  # JAX has no VJP for #8 / #9: a wanted gradient stays plain
        ("no_pos", "plain"),  # no raw positions: JAX's `edges.pos is not None`
        ("no_bond0", "plain"),
        ("attr32", "plain"),  # supports_*: edge_attr_dim 64
        ("plain_flag", "plain"),  # the caller did not ask for the kernels
        ("nograd_params", "conv_layer"),  # trainable parameters under no_grad
    ],
)
def test_dense_route_gates(case, route):
    """The rest of JAX's gates (`jamun_tpu/ops/conv.py:93-145`), and the
    port's own: a call that wants a gradient takes the plain path."""
    import dataclasses

    rng = np.random.default_rng(2)
    _, te = _edges(rng, True)
    attr = 32 if case == "attr32" else 64
    conv = Conv("24x0e + 8x1e", "16x0e + 8x1e", SH, attr)
    x = torch.randn(G, N, 48)
    if case == "no_pos":
        te = dataclasses.replace(te, pos=None)
    if case == "no_bond0":
        te = dataclasses.replace(te, bond0_embed=None)
    if case == "grad":
        assert conv.dense_route(x, te) == route
        return
    if case == "plain_flag":
        calls = []
        orig = conv.dense_route
        conv.dense_route = lambda *a: calls.append(1) or orig(*a)
        with torch.no_grad():
            conv(x, te)
        assert calls == []
        return
    with torch.no_grad():
        assert conv.dense_route(x, te) == route


# ---- E3Conv(pallas_variant="plane") ----

ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")


def _plane_setup(seed=0, n=16, nodes=NODES):
    from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig

    jb, tb = _batches(n, nodes)
    jden = JDenoiser(JE3Conv(**ARCH, use_pallas=False), JConfig(1.0, 0.5))
    params = jden.init(jax.random.PRNGKey(seed), jb)
    params = _perturb(params, 300 + seed, scale=0.3)
    port = E3Conv(**ARCH, pallas_variant="plane", device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    return jden, params, jb, Denoiser(port, DenoiserConfig(1.0, 0.5)), tb


def test_e3conv_plane_matches_jax(monkeypatch):
    """`E3Conv(pallas_variant="plane")` (K9's twin in every hidden layer, the
    projector plain) against JAX's XLA path, the function JAX's own plane
    test holds its kernel path to; K9 runs once per hidden layer."""
    jden, params, jb, den, tb = _plane_setup()
    spy = Spy(monkeypatch, conv_mod, PORT_ROUTES)
    c_noise = np.asarray([np.log(0.04) / 4.0], np.float32)
    want = np.asarray(jden.arch.apply(params, jb, jnp.asarray(c_noise), 0.9))
    with torch.no_grad():
        got = den.arch(tb, torch.from_numpy(c_noise), 0.9).numpy()
    assert _rel(got, want) < 1e-4 and np.abs(want).max() > 1e-2
    # projector (plain), then each hidden layer on K9
    assert spy.calls == ["fast_uvu_messages_dense"] + ["fused_uvu_conv_dense"] * 2
    # a call that wants a gradient runs the plain path in every layer
    spy.calls.clear()
    out = den.arch(tb, torch.from_numpy(c_noise), 0.9)
    out.sum().backward()
    assert spy.calls == ["fast_uvu_messages_dense"] * 3
    assert _rel(out.detach().numpy(), want) < 1e-4


def test_plane_ignores_fused_stack_and_keeps_the_tree():
    """"plane" takes no whole-model kernel whatever `fused_stack` says, and
    its parameter tree is the default variant's."""
    plane = E3Conv(**ARCH, pallas_variant="plane", fused_stack=True, device="cpu", seed=0)
    packed = E3Conv(**ARCH, device="cpu", seed=0)
    assert plane.state_dict().keys() == packed.state_dict().keys()
    tb = make_test_batch(num_graphs=1, max_nodes=8, device="cpu")
    assert not plane._stack_ok(tb, torch.zeros(1))
    with pytest.raises(ValueError):
        E3Conv(**ARCH, pallas_variant="lanes", device="cpu")


def test_plane_score_equivariance():
    """score(R y + t) = R score(y) - t / sigma^2 on the plane path."""
    _, _, _, den, tb = _plane_setup(seed=1, n=19, nodes=[19, 17])
    q, r = np.linalg.qr(np.random.default_rng(3).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    R = torch.from_numpy((q if np.linalg.det(q) > 0 else -q).astype(np.float32))
    shift = torch.tensor([0.3, -0.2, 0.5])
    mask = tb.node_mask[..., None].float()
    with torch.no_grad():
        s = den.score(tb, 0.04)
        s_rot = den.score(tb.replace_pos((tb.pos @ R.T + shift) * mask), 0.04)
    err = (s_rot - (s @ R.T - shift / 0.04**2) * mask).abs().max() / s.abs().max()
    assert float(err) < 1e-4
