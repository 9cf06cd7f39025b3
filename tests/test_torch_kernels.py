"""The plain twins of the port's kernels against the TPU kernels they
replace, run as the JAX package's own tests run them (interpret mode on the
CPU, f32):

  K1 `ops/cuda/edge_features`  vs `packed_conv.packed_edge_features`
  K2 `ops/cuda/conv_block`     vs `packed_conv.packed_separable_conv_layer(fuse_block=True)`
  K4 `ops/cuda/conv_block_bwd` vs `packed_conv.packed_conv_block_bwd`
  the trainable block (K2 forward, K4 backward) vs `jax.grad` through
      `ConvBlock(use_pallas=True)` (`make_trainable_conv_block`)

Tolerance: f32 on both sides; the TPU kernel reassociates the post-linear
(its o2-fold) and sums in another order, so 1e-5 relative with an absolute
floor of 2e-5 on O(1) outputs for the forward, and 1e-4 of each gradient
leaf's max for the backward (sums over every pair of the batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.ops.conv import ConvBlock as JConvBlock
from jamun_tpu.ops.pallas.packed_conv import (
    packed_conv_block_bwd,
    packed_edge_features,
    packed_separable_conv_layer,
)
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.ops.conv import ConvBlock
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda.conv_block import fused_conv_block_plain, pack_block_weights
from jamun_tpu_torch.ops.cuda.conv_block_bwd import conv_block_bwd_plain
from jamun_tpu_torch.ops.cuda.edge_features import edge_features, packed_rows
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
CUTOFF = 0.8
SH = "1x0e + 1x1e"


def _batches():
    kw = dict(num_graphs=2, max_nodes=16, nodes_per_graph=[14, 16], scale=0.3)
    return j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")


def _port_features(tb):
    return edge_features(
        tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, CUTOFF, 32, torch.float32
    )


def _jax_features(jb):
    return packed_edge_features(
        jnp.asarray(jb.pos), jnp.asarray(jb.node_mask), jnp.asarray(jb.bond_src),
        jnp.asarray(jb.bond_dst), jnp.asarray(jb.bond_mask), jnp.asarray(CUTOFF),
        n_radial=32, interpret=True,
    )


def test_edge_features_plain_matches_tpu_kernel():
    jb, tb = _batches()
    ef, bf = _port_features(tb)
    assert ef.shape == (2, 16, 16, 36) and bf.shape == (2, 16, 36)
    jef, jbf, _, _ = _jax_features(jb)
    ef_rows, bf_rows = packed_rows(ef, bf, 32)
    np.testing.assert_allclose(ef_rows.numpy(), np.asarray(jef), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bf_rows.numpy(), np.asarray(jbf), rtol=1e-5, atol=1e-6)
    adj = ef[..., 3]
    assert 0 < adj.sum() < adj.numel()  # pairs on both sides of the cutoff
    assert adj[0, 14:].sum() == 0 and adj[0, :, 14:].sum() == 0  # padded atoms


@pytest.mark.parametrize("irreps_in", ["16x0e + 8x1e", "24x0e"], ids=["hidden", "projector"])
def test_conv_block_plain_matches_tpu_kernel(irreps_in):
    from jamun_tpu.ops.graph import EdgeData
    from jamun_tpu_torch.ops.irreps import Irreps

    irreps_out = "16x0e + 8x1e"
    S, V = Irreps(irreps_in).sv_shape()
    rng = np.random.default_rng(11)
    jb, tb = _batches()
    x = rng.standard_normal((2, 16, Irreps(irreps_in).dim)).astype(np.float32)
    bond = rng.standard_normal((2, 32)).astype(np.float32)

    jm = JConvBlock(irreps_in, irreps_out, SH, 64, tensor_product="uvu")
    z = jnp.zeros
    dummy = EdgeData(
        sh_dense=z((2, 16, 16, 4)), attr_dense=z((2, 16, 16, 64)), adj=z((2, 16, 16)),
        sh_bond=z((2, 16, 4)), attr_bond=z((2, 16, 64)), bond_src=jnp.asarray(jb.bond_src),
        bond_dst=jnp.asarray(jb.bond_dst), bond_mask=z((2, 16)),
    )
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), dummy)
    noise = np.random.default_rng(12)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1 * noise.standard_normal(a.shape).astype(np.float32), p)
    pp = p["params"]

    jef, jbf, ebsT, ebd = _jax_features(jb)
    rp = pp["Conv_0"]["radial_nn"]
    want = packed_separable_conv_layer(
        jnp.asarray(x), jef, jbf, ebsT, ebd,
        rp["Dense_0"]["kernel"], rp["Dense_0"]["bias"], rp["Dense_1"]["kernel"], rp["Dense_1"]["bias"],
        jnp.asarray(bond[0]), jnp.asarray(bond[1]), dict(pp["Conv_0"]["_post_linear"]),
        S=S, V=V, out_blocks=((16, 0), (8, 0), (8, 1)), n_radial=32, interpret=True,
        fuse_block=True, lin2_params=dict(pp["IrrepsLinear_1"]),
        skip_params=dict(pp["IrrepsLinear_0"]),
    )

    tm = ConvBlock(irreps_in, irreps_out, SH, 64)
    tm.load_state_dict(from_jax_params(p), strict=True)
    ef, bf = _port_features(tb)
    with torch.no_grad():
        w = pack_block_weights(
            tm.Conv_0.radial_nn, tm.Conv_0._post_linear, tm.IrrepsLinear_1, tm.IrrepsLinear_0,
            torch.from_numpy(bond[0]), torch.from_numpy(bond[1]), S=S, V=V, cdt=torch.float32,
        )
        got = fused_conv_block_plain(torch.from_numpy(x), ef, bf, tb.bond_src, tb.bond_dst, w)
        # the module path through the wrapper gives the same numbers
        via_module = tm.fused(
            torch.from_numpy(x), k2.PairFeatures(ef, bf, tb.bond_src, tb.bond_dst),
            torch.from_numpy(bond[0]), torch.from_numpy(bond[1]),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(via_module.numpy(), got.numpy())
    assert np.abs(np.asarray(want)).max() > 0.1  # non-vacuous


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _block_setup(irreps_in, seed=11):
    """A JAX ConvBlock's params (perturbed), the same block in the port, the
    input, the bondedness embeddings and a cotangent, from numpy seeds."""
    from jamun_tpu.ops.graph import EdgeData
    from jamun_tpu_torch.ops.irreps import Irreps

    irreps_out = "16x0e + 8x1e"
    rng = np.random.default_rng(seed)
    jb, tb = _batches()
    x = rng.standard_normal((2, 16, Irreps(irreps_in).dim)).astype(np.float32)
    bond = rng.standard_normal((2, 32)).astype(np.float32)
    cot = rng.standard_normal((2, 16, Irreps(irreps_out).dim)).astype(np.float32)
    jm = JConvBlock(irreps_in, irreps_out, SH, 64, tensor_product="uvu")
    z = jnp.zeros
    dummy = EdgeData(
        sh_dense=z((2, 16, 16, 4)), attr_dense=z((2, 16, 16, 64)), adj=z((2, 16, 16)),
        sh_bond=z((2, 16, 4)), attr_bond=z((2, 16, 64)), bond_src=jnp.asarray(jb.bond_src),
        bond_dst=jnp.asarray(jb.bond_dst), bond_mask=z((2, 16)),
    )
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), dummy)
    noise = np.random.default_rng(seed + 1)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1 * noise.standard_normal(a.shape).astype(np.float32), p)
    tm = ConvBlock(irreps_in, irreps_out, SH, 64)
    tm.load_state_dict(from_jax_params(p), strict=True)
    return jb, tb, p, tm, x, bond, cot


def _port_block_grads(tm):
    """param name -> grad of the port block (zeros where autograd left none)."""
    return {n: (q.grad if q.grad is not None else torch.zeros_like(q)).numpy()
            for n, q in tm.named_parameters()}


def _jax_block_grads(dparams):
    """flax grad tree of a ConvBlock -> {dotted name: array}."""
    flat = jax.tree_util.tree_flatten_with_path(dparams)[0]
    return {".".join(k.key for k in path[1:] if hasattr(k, "key")): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("irreps_in", ["16x0e + 8x1e", "24x0e"], ids=["hidden", "projector"])
def test_conv_block_bwd_plain_matches_tpu_kernel(irreps_in):
    """K4's plain twin, fed K2's residuals, and mapped back to the block's
    parameters by autograd through `block_master_weights` (the path the
    trainable block takes), against `packed_conv_block_bwd(interpret=True)`."""
    from jamun_tpu_torch.ops.irreps import Irreps

    S, V = Irreps(irreps_in).sv_shape()
    jb, tb, p, tm, x, bond, cot = _block_setup(irreps_in)
    pp = p["params"]
    rp = pp["Conv_0"]["radial_nn"]
    jef, jbf, ebsT, ebd = _jax_features(jb)
    dx, dw1, db1, dw2, db2, dbond0, dbond1, dpl, dlin2, dskip = packed_conv_block_bwd(
        jnp.asarray(cot), jnp.asarray(x), jef, jbf, ebsT, ebd,
        rp["Dense_0"]["kernel"], rp["Dense_0"]["bias"], rp["Dense_1"]["kernel"], rp["Dense_1"]["bias"],
        jnp.asarray(bond[0]), jnp.asarray(bond[1]), dict(pp["Conv_0"]["_post_linear"]),
        dict(pp["IrrepsLinear_1"]), dict(pp["IrrepsLinear_0"]),
        S=S, V=V, out_blocks=((16, 0), (8, 0), (8, 1)), n_radial=32, interpret=True,
    )

    b0, b1 = (torch.from_numpy(b).requires_grad_() for b in bond)
    ef, bf = _port_features(tb)
    masters = k2.block_master_weights(
        tm.Conv_0.radial_nn, tm.Conv_0._post_linear, tm.IrrepsLinear_1, tm.IrrepsLinear_0,
        b0, b1, S=S, V=V,
    )
    xt = torch.from_numpy(x)
    with torch.no_grad():
        w = k2.cast_block_weights(masters, torch.float32)
        agg, deg = k2.conv_block_residuals_plain(xt, ef, bf, tb.bond_src, tb.bond_dst, w)
        grads = conv_block_bwd_plain(torch.from_numpy(cot), xt, ef, bf, tb.bond_src, tb.bond_dst,
                                     w, agg, deg)
    scales = k2.linear_scales(S, V, w.Sc, w.Vg)
    pairs = [
        (m, grads[k] / scales.get(k, 1.0))
        for m, k in zip(masters.tensors(), k2.BlockWeights._fields) if m.requires_grad
    ]
    torch.autograd.backward([m for m, _ in pairs], [d for _, d in pairs])

    got = _port_block_grads(tm)
    want = _jax_block_grads({"params": {
        "Conv_0": {"radial_nn": {"Dense_0": {"kernel": dw1, "bias": db1},
                                 "Dense_1": {"kernel": dw2, "bias": db2}},
                   "_post_linear": dpl},
        "IrrepsLinear_1": dlin2, "IrrepsLinear_0": dskip,
    }})
    assert set(got) == set(want)
    want.update(dx=dx, bond0=dbond0, bond1=dbond1)
    got.update(dx=grads["dx"].numpy(), bond0=b0.grad.numpy(), bond1=b1.grad.numpy())
    for name, ref in want.items():
        assert np.abs(ref).max() > 0, name  # every leaf is exercised
        assert _rel(got[name], ref) < 1e-4, (name, _rel(got[name], ref))


def test_trainable_block_grads_match_jax():
    """`ConvBlock.fused` under autograd (K2 forward, K4 backward through the
    plain twins on the CPU) against `jax.grad` through the JAX kernel path
    (`ConvBlock(use_pallas=True)`, interpret mode), for x and every
    parameter, by name."""
    from jamun_tpu.ops.graph import dense_edge_data
    from jamun_tpu.ops.radial import soft_one_hot_linspace
    from jamun_tpu.ops.sh import spherical_harmonics
    import functools

    jb, tb, p, tm, x, bond, cot = _block_setup("16x0e + 8x1e", seed=21)
    bond0, bond1 = jnp.asarray(bond[0]), jnp.asarray(bond[1])

    def attr_fn(dist, bonded):
        bond_part = jnp.broadcast_to(bond1 if bonded else bond0, dist.shape + (32,))
        radial = soft_one_hot_linspace(dist, 0.0, CUTOFF, 32, basis="gaussian", cutoff=True)
        return jnp.concatenate([bond_part, radial], axis=-1)

    edges = dense_edge_data(
        jnp.asarray(jb.pos), jnp.asarray(jb.node_mask), jnp.asarray(jb.bond_src),
        jnp.asarray(jb.bond_dst), jnp.asarray(jb.bond_mask), jnp.asarray(CUTOFF),
        functools.partial(spherical_harmonics, SH), attr_fn,
        dense=True, bond0_embed=bond0, bond1_embed=bond1,
    )
    jm = JConvBlock("16x0e + 8x1e", "16x0e + 8x1e", SH, 64, tensor_product="uvu", use_pallas=True)
    jcot = jnp.asarray(cot)
    dparams, dx = jax.grad(
        lambda pr, xx: jnp.sum(jm.apply(pr, xx, edges) * jcot), argnums=(0, 1)
    )(jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    ef, bf = _port_features(tb)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm.fused(xt, k2.PairFeatures(ef, bf, tb.bond_src, tb.bond_dst),
                   torch.from_numpy(bond[0]), torch.from_numpy(bond[1]))
    assert out.grad_fn is not None and "TrainableConvBlock" in type(out.grad_fn).__name__
    (out * torch.from_numpy(cot)).sum().backward()

    got, want = _port_block_grads(tm), _jax_block_grads(dparams)
    assert set(got) == set(want) and len(want) == 15
    got["x"], want["x"] = xt.grad.numpy(), np.asarray(dx)
    for name, ref in want.items():
        assert np.abs(ref).max() > 0, name
        assert _rel(got[name], ref) < 1e-4, (name, _rel(got[name], ref))


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cast_weights_and_cpu_residuals(cdt):
    """`cast_block_weights` divides each IrrepsLinear kernel by sqrt(fan-in)
    rounded to the compute dtype, through one cached divisor per (value,
    dtype, device), so no forward makes a new device tensor. The CPU
    wrapper's residual mode gives the plain twin's output and residuals
    exactly (one aggregation for both)."""
    from jamun_tpu_torch.ops.irreps import Irreps

    _, tb, _, tm, x, bond, _ = _block_setup("16x0e + 8x1e")
    S, V = Irreps("16x0e + 8x1e").sv_shape()
    masters = k2.block_master_weights(
        tm.Conv_0.radial_nn, tm.Conv_0._post_linear, tm.IrrepsLinear_1, tm.IrrepsLinear_0,
        torch.from_numpy(bond[0]), torch.from_numpy(bond[1]), S=S, V=V,
    )
    with torch.no_grad():
        w = k2.cast_block_weights(masters, cdt)
    for k, s in k2.linear_scales(S, V, w.Sc, w.Vg).items():
        d = k2.rounded_divisor(s, cdt, torch.device("cpu"))
        assert d is k2.rounded_divisor(s, cdt, torch.device("cpu"))
        assert d.dtype == cdt and d.item() == torch.tensor(s, dtype=cdt).item()
        torch.testing.assert_close(getattr(w, k), getattr(masters, k).detach().to(cdt) / d,
                                   rtol=0, atol=0)

    ef, bf = edge_features(
        tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, CUTOFF, 32, cdt
    )
    xt = torch.from_numpy(x).to(cdt)
    args = (xt, ef, bf, tb.bond_src, tb.bond_dst, w)
    with torch.no_grad():
        out, agg, deg = k2.fused_conv_block(*args, residuals=True)
        agg_p, deg_p = k2.conv_block_residuals_plain(*args)
        torch.testing.assert_close(out, k2.fused_conv_block_plain(*args), rtol=0, atol=0)
    torch.testing.assert_close((agg, deg), (agg_p, deg_p), rtol=0, atol=0)
    assert agg.abs().max() > 0 and deg.max() > 0


@pytest.mark.parametrize("grad_mode", [True, False], ids=["grad", "no_grad"])
def test_edge_features_refuse_position_gradients(grad_mode):
    """JAX's `packed_edge_features` refuses dL/dpos; the port's K1 (either
    device) raises too instead of dropping the gradient. Positions that
    need no gradient, or grad mode off, go through."""
    _, tb = _batches()
    pos = tb.pos.clone().requires_grad_()
    args = (tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, CUTOFF, 32, torch.float32)
    with torch.set_grad_enabled(grad_mode):
        if grad_mode:
            with pytest.raises(NotImplementedError, match="positions"):
                edge_features(pos, *args)
        else:
            ef, _ = edge_features(pos, *args)
            assert not ef.requires_grad
    ef, _ = edge_features(tb.pos, *args)
    assert ef.shape == (2, 16, 16, 36)
