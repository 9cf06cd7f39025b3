"""The rest of the equivariant-ops library against JAX (CPU, f32): Wigner D
to l = 3, spherical harmonics to lmax 3, `depthwise_tp`, the experimental
product (`full_tensor_product`, `external_linear`,
`ExperimentalTensorProduct`), `equivariant_layer_norm`, the extract / scale
and pack / unpack helpers, the wrappers, `EquivariantMLP` with l = 2 hidden
irreps and its layer norm, and each one's
equivariance under the port's own Wigner D. Inputs come from seeded numpy;
JAX's parameters (perturbed, so that no leaf is at its initial value) reach
the port through `params.from_jax_params`. Outputs within 1e-5 of their max,
gradients within 1e-4 of each leaf's max; each check states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.ops import extract as j_extract
from jamun_tpu.ops import pack_unpack as j_pack
from jamun_tpu.ops import wrappers as j_wrappers
from jamun_tpu.ops.experimental_tp import ExperimentalTensorProduct as JExperimentalTP
from jamun_tpu.ops.experimental_tp import external_linear as j_external_linear
from jamun_tpu.ops.experimental_tp import full_tensor_product as j_full_tensor_product
from jamun_tpu.ops.irreps import Irreps as JIrreps
from jamun_tpu.ops.layer_norm import equivariant_layer_norm as j_layer_norm
from jamun_tpu.ops.linear import IrrepsLinear as JIrrepsLinear
from jamun_tpu.ops.mlp import EquivariantMLP as JEquivariantMLP
from jamun_tpu.ops.sh import spherical_harmonics as j_sh
from jamun_tpu.ops.tensor_product import depthwise_tp as j_depthwise_tp
from jamun_tpu.ops.tensor_product import scale_irreps as j_scale_irreps
from jamun_tpu.ops.wigner import wigner_D_from_matrix as j_wigner_D
from jamun_tpu_torch.ops import extract, pack_unpack, wrappers
from jamun_tpu_torch.ops.cg import sh_normalization_constant
from jamun_tpu_torch.ops.experimental_tp import (
    ExperimentalTensorProduct,
    external_linear,
    full_tensor_product,
)
from jamun_tpu_torch.ops.irreps import Irreps, pack_irreps, unpack_irreps
from jamun_tpu_torch.ops.layer_norm import equivariant_layer_norm
from jamun_tpu_torch.ops.linear import IrrepsLinear
from jamun_tpu_torch.ops.mlp import EquivariantMLP
from jamun_tpu_torch.ops.sh import spherical_harmonics
from jamun_tpu_torch.ops.tensor_product import depthwise_tp, scale_irreps, scale_irreps_transposed
from jamun_tpu_torch.ops.wigner import random_rotation, wigner_D_from_matrix
from jamun_tpu_torch.params import from_jax_params

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )


def _D(irreps, R):
    return torch.from_numpy(Irreps(irreps).rotation_matrix(R).astype(np.float32))


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_wigner_d_equals_jax(l):
    """The same recursion over the same coupling tensors: within 1e-12 (f64);
    D is orthogonal and a representation, D(R1 R2) = D(R1) D(R2)."""
    rng = np.random.default_rng(l)
    R1, R2 = random_rotation(rng), random_rotation(rng)
    D = wigner_D_from_matrix(l, R1)
    np.testing.assert_allclose(D, j_wigner_D(l, R1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(D @ D.T, np.eye(2 * l + 1), atol=1e-12)
    np.testing.assert_allclose(wigner_D_from_matrix(l, R1 @ R2), D @ wigner_D_from_matrix(l, R2), atol=1e-12)
    irreps = "2x0e + 1x1o + 1x2e + 1x3o"
    R = -R1  # improper: the odd blocks take the parity sign
    np.testing.assert_allclose(Irreps(irreps).rotation_matrix(R), JIrreps(irreps).rotation_matrix(R),
                               atol=1e-12)


@pytest.mark.parametrize("irreps_sh", ["1x0e + 1x1e + 1x2e", "1x0e + 1x1e + 1x2e + 1x3e", "2x2e + 1x1e"])
def test_spherical_harmonics_equal_jax(irreps_sh):
    """lmax 2 and 3: within 1e-5 of the max; |Y_l|^2 = 2l + 1 on unit
    vectors; Y(R v) = D(R) Y(v) within 1e-5."""
    v = _randn(0, 7, 5, 3)
    got = spherical_harmonics(irreps_sh, torch.from_numpy(v))
    want = np.asarray(j_sh(irreps_sh, jnp.asarray(v)))
    assert got.shape == want.shape == (7, 5, Irreps(irreps_sh).dim)
    assert _rel(got.numpy(), want) < 1e-5
    for mi, sl in zip(Irreps(irreps_sh), Irreps(irreps_sh).slices()):
        y = got[..., sl].reshape(7, 5, mi.mul, mi.ir.dim)
        np.testing.assert_allclose((y**2).sum(-1).numpy(), 2 * mi.ir.l + 1, rtol=1e-5)
    R = random_rotation(np.random.default_rng(1)).astype(np.float32)
    rot = spherical_harmonics(irreps_sh, torch.from_numpy(v @ R.T))
    assert _rel(rot.numpy(), (got @ _D(irreps_sh, R).T).numpy()) < 1e-5
    assert sh_normalization_constant(3) != 0


def test_depthwise_tp_matches_jax():
    """`4x0e + 3x1e + 2x2e` (x) `1x0e + 1x1e + 1x2e` -> `5x0e + 2x1e +
    1x2e` (the shape of tests/test_irreps_ops.py): paths, dtp irreps and
    the product within 1e-5 of the max; equivariant within 1e-5."""
    args = ("4x0e + 3x1e + 2x2e", "1x0e + 1x1e + 1x2e", "5x0e + 2x1e + 1x2e")
    (tp, dtp), (jtp, jdtp) = depthwise_tp(*args), j_depthwise_tp(*args)
    assert str(dtp) == str(jdtp) and tp.weight_numel == jtp.weight_numel
    assert [(i.i_in1, i.i_in2, i.i_out, i.mode, i.path_weight, i.weight_shape) for i in tp.instructions] == [
        (i.i_in1, i.i_in2, i.i_out, i.mode, i.path_weight, i.weight_shape) for i in jtp.instructions]
    x1, x2 = _randn(1, 6, tp.irreps_in1.dim), _randn(2, 6, tp.irreps_in2.dim)
    w = _randn(3, 6, tp.weight_numel)
    got = tp(*map(torch.from_numpy, (x1, x2, w)))
    assert _rel(got.numpy(), np.asarray(jtp(*map(jnp.asarray, (x1, x2, w))))) < 1e-5
    R = random_rotation(np.random.default_rng(4)).astype(np.float32)
    rot = tp(torch.from_numpy(x1) @ _D(args[0], R).T, torch.from_numpy(x2) @ _D(args[1], R).T,
             torch.from_numpy(w))
    assert _rel(rot.numpy(), (got @ _D(dtp, R).T).numpy()) < 1e-5


def test_full_tensor_product_and_external_linear_match_jax():
    """`2x0e + 1x1e` (x) `1x0e + 1x1e`: output irreps of dim 2 + 6 + 3 + 1 +
    3 + 5 (as tests/test_experimental_tp.py), values within 1e-5 of the max;
    the external linear onto `3x0e + 2x1e + 1x2e` within 1e-5."""
    i1, i2 = "2x0e + 1x1e", "1x0e + 1x1e"
    x1, x2 = _randn(5, 4, Irreps(i1).dim), _randn(6, 4, Irreps(i2).dim)
    got, irreps = full_tensor_product(torch.from_numpy(x1), torch.from_numpy(x2), i1, i2)
    want, jirreps = j_full_tensor_product(jnp.asarray(x1), jnp.asarray(x2), JIrreps(i1), JIrreps(i2))
    assert str(irreps) == str(jirreps) and irreps.dim == 2 + 6 + 3 + 1 + 3 + 5
    assert _rel(got.numpy(), np.asarray(want)) < 1e-5
    lin, jlin = external_linear(irreps, "3x0e + 2x1e + 1x2e"), j_external_linear(jirreps, "3x0e + 2x1e + 1x2e")
    assert lin.weight_numel == jlin.weight_numel
    w = _randn(7, 4, lin.weight_numel)
    out = lin(got, torch.from_numpy(w))
    assert _rel(out.numpy(), np.asarray(jlin(want, jnp.asarray(w)))) < 1e-5
    # per-path weights give the same numbers as the one flat tensor
    split = lin(got, [torch.from_numpy(w)[..., s] for s in lin.weight_slices()])
    assert torch.equal(split, out)


@pytest.mark.parametrize("irreps", [("3x0e + 2x1e", "1x0e + 1x1e", "4x0e + 2x1e"),
                                    ("2x0e + 2x1e + 1x2e", "1x0e + 1x1e + 1x2e", "3x0e + 1x1e + 2x2e")])
def test_experimental_tensor_product_matches_jax(irreps):
    """Per-element weights: within 1e-5 of the max; equivariant within 1e-5
    of the max under the port's Wigner D; gradients of a projection within
    1e-4 of each input's max."""
    tp, jtp = ExperimentalTensorProduct(*irreps), JExperimentalTP(*irreps)
    assert tp.weight_numel == jtp.weight_numel
    x1, x2 = _randn(8, 5, tp.irreps_in1.dim), _randn(9, 5, tp.irreps_in2.dim)
    w, proj = _randn(10, 5, tp.weight_numel), _randn(11, 5, tp.irreps_out.dim)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x1, x2, w)]
    got = tp(*ins)
    assert _rel(got.detach().numpy(), np.asarray(jax.jit(jtp)(*map(jnp.asarray, (x1, x2, w))))) < 1e-5
    (got * torch.from_numpy(proj)).sum().backward()
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jtp(*a) * proj), argnums=(0, 1, 2)))(
        *map(jnp.asarray, (x1, x2, w)))
    for t, g in zip(ins, jg):
        assert _rel(t.grad.numpy(), np.asarray(g)) < 1e-4
    R = random_rotation(np.random.default_rng(12)).astype(np.float32)
    with torch.no_grad():
        rot = tp(ins[0] @ _D(irreps[0], R).T, ins[1] @ _D(irreps[1], R).T, ins[2])
        assert _rel(rot.numpy(), (got @ _D(irreps[2], R).T).numpy()) < 1e-5


@pytest.mark.parametrize("irreps", ["4x0e + 3x1e + 2x2e", "3x1e + 5x0e + 1x1o"])
def test_equivariant_layer_norm_matches_jax(irreps):
    """Within 1e-5 of the max, gradients within 1e-4; equivariant within 1e-5."""
    x, proj = _randn(13, 3, 4, Irreps(irreps).dim), _randn(14, 3, 4, Irreps(irreps).dim)
    xt = torch.from_numpy(x).requires_grad_()
    got = equivariant_layer_norm(xt, irreps)
    assert _rel(got.detach().numpy(), np.asarray(j_layer_norm(jnp.asarray(x), irreps))) < 1e-5
    (got * torch.from_numpy(proj)).sum().backward()
    jg = jax.jit(jax.grad(lambda a: jnp.sum(j_layer_norm(a, irreps) * proj)))(jnp.asarray(x))
    assert _rel(xt.grad.numpy(), np.asarray(jg)) < 1e-4
    R = random_rotation(np.random.default_rng(15)).astype(np.float32)
    D = _D(irreps, R)
    with torch.no_grad():
        assert _rel(equivariant_layer_norm(xt @ D.T, irreps).numpy(), (got @ D.T).numpy()) < 1e-5


def test_extract_scale_pack_unpack_match_jax():
    """Extract, scale (and its transposed slot-padded layout), mul <-> axis
    and pack / unpack: equal to JAX's outputs (pure data movement and one
    product each, so bit for bit)."""
    irreps = "4x0e + 2x1e + 2x2e + 2x0e"
    x = _randn(16, 3, Irreps(irreps).dim)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for keep in ("0e", ["0e", "2e"], "1o"):
        ex, jex = extract.ExtractIrreps(irreps, keep), j_extract.ExtractIrreps(irreps, keep)
        assert str(ex.irreps_out) == str(jex.irreps_out)
        np.testing.assert_array_equal(ex(xt).numpy(), np.asarray(jex(xj)))
    s = _randn(17, 3, Irreps(irreps).num_irreps)
    np.testing.assert_array_equal(extract.ScaleIrreps(irreps)(xt, torch.from_numpy(s)).numpy(),
                                  np.asarray(j_extract.ScaleIrreps(irreps)(xj, jnp.asarray(s))))
    np.testing.assert_array_equal(scale_irreps(xt, torch.from_numpy(s), irreps).numpy(),
                                  np.asarray(j_scale_irreps(xj, jnp.asarray(s), irreps)))
    # the transposed layout: rows Sp + 3 Vp (S = 20 -> 32, V = 5 -> 16), atoms on the last axis
    from jamun_tpu.ops.tensor_product import scale_irreps_transposed as j_sit

    xT, sc = _randn(18, 2, 32 + 3 * 16, 7), _randn(19, 2, 25)
    np.testing.assert_array_equal(
        scale_irreps_transposed(torch.from_numpy(xT), torch.from_numpy(sc), "20x0e + 5x1e").numpy(),
        np.asarray(j_sit(jnp.asarray(xT), jnp.asarray(sc), "20x0e + 5x1e")))
    m2a, jm2a = pack_unpack.MulToAxis(irreps, 2), j_pack.MulToAxis(irreps, 2)
    assert str(m2a.irreps_out) == str(jm2a.irreps_out)
    folded = m2a(xt)
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jm2a(xj)))
    a2m, ja2m = pack_unpack.AxisToMul(m2a.irreps_out, 2), j_pack.AxisToMul(jm2a.irreps_out, 2)
    assert str(a2m.irreps_out) == str(ja2m.irreps_out)
    np.testing.assert_array_equal(a2m(folded).numpy(), np.asarray(ja2m(jm2a(xj))))
    with pytest.raises(ValueError, match="divisible"):
        pack_unpack.mul_to_axis(xt, irreps, 3)
    fields = list(unpack_irreps(xt, Irreps(irreps)))
    assert [(m, str(ir)) for m, ir, _ in fields] == [(4, "0e"), (2, "1e"), (2, "2e"), (2, "0e")]
    assert torch.equal(pack_irreps([f for _, _, f in fields], Irreps(irreps)), xt)


def _module_pair(jmod, port_mod, x, seed, *args):
    """JAX's init (perturbed) and apply, the port's module loaded from it."""
    params = _perturbed(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), *args), seed + 50)
    port_mod.load_state_dict(from_jax_params(params), strict=True)
    return params


@pytest.mark.parametrize("use_layer_norm", [False, True])
def test_equivariant_mlp_general_l_matches_jax(use_layer_norm):
    """`EquivariantMLP` with l = 2 hidden irreps (attention's feed-forward
    shape, 4 x mul) and JAX's `use_layer_norm`: within 1e-5 of the max,
    parameter gradients within 1e-4 of each leaf's max, equivariant."""
    irreps = "4x0e + 2x1e + 1x2e"
    hidden = [Irreps([(4 * mi.mul, mi.ir) for mi in Irreps(irreps)])]
    jm = JEquivariantMLP(irreps, irreps, [str(h) for h in hidden], use_layer_norm=use_layer_norm)
    pm = EquivariantMLP(irreps, irreps, hidden, use_layer_norm=use_layer_norm)
    x, proj = _randn(20, 3, 5, Irreps(irreps).dim), _randn(21, 3, 5, Irreps(irreps).dim)
    params = _module_pair(jm, pm, x, 0)
    got = pm(torch.from_numpy(x))
    assert _rel(got.detach().numpy(), np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))) < 1e-5
    (got * torch.from_numpy(proj)).sum().backward()
    jg = from_jax_params(jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * proj)))(params))
    for n, p in pm.named_parameters():
        assert _rel(p.grad.numpy(), jg[n].numpy()) < 1e-4, n
    R = random_rotation(np.random.default_rng(22)).astype(np.float32)
    D = _D(irreps, R)
    with torch.no_grad():
        assert _rel(pm(torch.from_numpy(x) @ D.T).numpy(), (got @ D.T).detach().numpy()) < 1e-5


def _layer(irreps_in, irreps_out):
    return IrrepsLinear(irreps_in, irreps_out)


def _jlayer(irreps_in, irreps_out):
    return JIrrepsLinear(irreps_in, irreps_out)


@pytest.mark.parametrize("name", ["Gated", "GateWrapper", "LinearSelfInteraction",
                                  "LearnableSkipConnection", "GateActivation"])
def test_wrappers_match_jax(name):
    """Each wrapper at `4x0e + 2x1e + 1x2e` from JAX's parameters: within
    1e-5 of the max; the parameter trees carry the same names; equivariant
    within 1e-5 of the max."""
    irreps = "4x0e + 2x1e + 1x2e"
    D_in = Irreps(irreps).dim
    x, x2 = _randn(24, 3, D_in), _randn(25, 3, D_in)
    args = ()
    if name == "Gated":
        jm, pm = j_wrappers.Gated(_jlayer, irreps, irreps), wrappers.Gated(_layer, irreps, irreps)
    elif name == "GateWrapper":
        jm, pm = j_wrappers.GateWrapper(irreps, irreps), wrappers.GateWrapper(irreps, irreps)
    elif name == "LinearSelfInteraction":
        jm = j_wrappers.LinearSelfInteraction(j_wrappers.GateWrapper(irreps, irreps), irreps, irreps)
        pm = wrappers.LinearSelfInteraction(wrappers.GateWrapper(irreps, irreps), irreps, irreps)
    elif name == "LearnableSkipConnection":
        jm, pm = j_wrappers.LearnableSkipConnection(), wrappers.LearnableSkipConnection()
        args = (x2,)
    else:
        gate_in = wrappers.GateActivation(irreps).gate.irreps_in
        jm, pm = j_wrappers.GateActivation(irreps), wrappers.GateActivation(irreps)
        x = _randn(26, 3, gate_in.dim)
    if name == "GateActivation":  # no parameters
        params = {"params": {}}
    else:
        params = _module_pair(jm, pm, x, 2, *map(jnp.asarray, args))
    want = np.asarray(jm.apply(params, jnp.asarray(x), *map(jnp.asarray, args)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), *map(torch.from_numpy, args))
        assert _rel(got.numpy(), want) < 1e-5
        R = random_rotation(np.random.default_rng(27)).astype(np.float32)
        d_in = _D(wrappers.GateActivation(irreps).gate.irreps_in if name == "GateActivation" else irreps, R)
        D = _D(irreps, R)
        rot = pm(torch.from_numpy(x) @ d_in.T, *(torch.from_numpy(a) @ D.T for a in args))
        assert _rel(rot.numpy(), (got @ D.T).numpy()) < 1e-5


def test_wrapper_trees_have_flax_names():
    """`Gated` names the layer it builds as flax does (`IrrepsLinear_0`)."""
    assert sorted(wrappers.Gated(_layer, "2x0e + 1x1e", "2x0e + 1x1e").state_dict()) == [
        "IrrepsLinear_0.w_0_0", "IrrepsLinear_0.w_0_1", "IrrepsLinear_0.w_1_2"]


def test_config_targets_of_the_new_modules_resolve():
    """`jamun_tpu.ops.*` targets of the new modules build the port's
    modules through `instantiate` (the package's exports, the modules and
    `contrib`), with a `_partial_` radial network; every name JAX's
    `jamun_tpu.ops` exports resolves in the port."""
    import jamun_tpu.ops as jops

    import jamun_tpu_torch.ops as ops
    from jamun_tpu_torch.config.instantiate import instantiate, locate
    from jamun_tpu_torch.ops.attention import TransformerBlock
    from jamun_tpu_torch.ops.contrib.equifold import Equiformer

    block = instantiate({"_target_": "jamun_tpu.ops.TransformerBlock", "irreps_in": "4x0e + 2x1e",
                         "irreps_out": "4x0e + 2x1e", "irreps_sh": "1x0e + 1x1e", "edge_attr_dim": 8,
                         "n_head": 2})
    assert isinstance(block, TransformerBlock)
    eqf = instantiate({"_target_": "jamun_tpu.ops.contrib.Equiformer", "nc_s": 4, "nc_v": 4,
                       "num_heads": 2, "radial_nn": {"_target_": "jamun_tpu.ops.contrib.equifold.RadialNN",
                                                     "_partial_": True, "rc": 1.0}})
    assert isinstance(eqf, Equiformer) and hasattr(eqf, "RadialNN_0")
    for path in ("jamun_tpu.ops.experimental_tp.ExperimentalTensorProduct", "jamun_tpu.ops.conv.ExperimentalConv",
                 "jamun_tpu.ops.layer_norm.equivariant_layer_norm", "jamun_tpu.ops.wrappers.GateWrapper",
                 "jamun_tpu.ops.pack_unpack.MulToAxis", "jamun_tpu.ops.extract.ExtractIrreps",
                 "jamun_tpu.ops.wigner.wigner_D_from_matrix"):
        assert callable(locate(path)), path
    jax_names = {n for n in dir(jops) if not n.startswith("_") and not isinstance(getattr(jops, n), type(jops))}
    assert jax_names <= set(ops.__all__), sorted(jax_names - set(ops.__all__))
    for n in ops.__all__:
        assert getattr(ops, n) is locate(f"jamun_tpu.ops.{n}"), n
