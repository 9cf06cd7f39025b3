"""The plain twins of the port's two kernels against the TPU kernels they
replace, run as the JAX package's own tests run them (interpret mode on the
CPU, f32):

  K1 `ops/cuda/edge_features`  vs `packed_conv.packed_edge_features`
  K2 `ops/cuda/conv_block`     vs `packed_conv.packed_separable_conv_layer(fuse_block=True)`

Tolerance: f32 on both sides; the TPU kernel reassociates the post-linear
(its o2-fold) and sums in another order, so 1e-5 relative with an absolute
floor of 2e-5 on O(1) outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.ops.conv import ConvBlock as JConvBlock
from jamun_tpu.ops.pallas.packed_conv import packed_edge_features, packed_separable_conv_layer
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.ops.conv import ConvBlock
from jamun_tpu_torch.ops.cuda.conv_block import fused_conv_block_plain, pack_block_weights
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
            torch.from_numpy(x), ef, bf, tb.bond_src, tb.bond_dst,
            torch.from_numpy(bond[0]), torch.from_numpy(bond[1]),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(via_module.numpy(), got.numpy())
    assert np.abs(np.asarray(want)).max() > 0.1  # non-vacuous
