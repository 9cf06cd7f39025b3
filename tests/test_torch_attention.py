"""`MultiheadAttention` and `TransformerBlock` of the port against JAX's
(`jamun_tpu/ops/attention.py`) on the CPU in f32: `8x0e + 4x1e`, 2 heads,
SH `1x0e + 1x1e`, 8-wide edge attributes (the shapes of
tests/test_extras.py), two graphs with bonds, padded or not. The same
positions and features go to both (seeded numpy); the port's parameters are
JAX's (perturbed by 0.3) through `params.from_jax_params`. Outputs within
1e-5 of their max, the gradients of a projection within 1e-4 of each leaf's
max, and the port's E(3) equivariance under its own Wigner D within 1e-5.

JAX's gradients are NaN in the queries, keys and `dot_w` as soon as one
destination has no incoming edge, a padded atom say (ROADMAP.md §C): the
quotient's gradient in its clamped denominator is -ct * 0 / 1e-40, and
1e-40 is 0 in f32. So the gradients are held to JAX's on graphs without
padding, and on padded graphs to the port's own on the same atoms unpadded.
JAX's position gradients are NaN on any graph: its SH normalize the self
pair's zero edge vector, and the norm's gradient at 0 is NaN (torch takes
0 there); the port's are checked finite and equivariant instead.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.ops.attention import MultiheadAttention as JMultiheadAttention
from jamun_tpu.ops.attention import TransformerBlock as JTransformerBlock
from jamun_tpu.ops.graph import dense_edge_data as j_dense_edge_data
from jamun_tpu.ops.sh import spherical_harmonics as j_sh
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.ops.attention import MultiheadAttention, TransformerBlock, split_irreps
from jamun_tpu_torch.ops.graph import dense_edge_data
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.ops.sh import spherical_harmonics
from jamun_tpu_torch.ops.wigner import random_rotation
from jamun_tpu_torch.params import from_jax_params, to_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
IRREPS, SH, ATTR, HEADS, CUTOFF = "8x0e + 4x1e", "1x0e + 1x1e", 8, 2, 0.8
PADDED = dict(num_graphs=2, max_nodes=9, nodes_per_graph=[9, 6], max_bonds=16, scale=0.35, seed=3)
FULL = dict(PADDED, nodes_per_graph=[9, 9])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _attr(d, bonded, lib):
    """Edge attributes: the distance, scaled per channel, bonds shifted."""
    scale = lib.asarray(np.linspace(0.5, 2.0, ATTR, dtype=np.float32))
    return lib.sin(d[..., None] * scale + (1.0 if bonded else 0.0))


def _j_edges(batch, pos):
    return j_dense_edge_data(
        pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, jnp.asarray(CUTOFF),
        sh_fn=functools.partial(j_sh, SH), attr_fn=functools.partial(_attr, lib=jnp),
    )


def _edges(batch, pos):
    return dense_edge_data(
        pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, CUTOFF,
        functools.partial(spherical_harmonics, SH), functools.partial(_attr, lib=torch),
    )


def _modules(name):
    if name == "MultiheadAttention":
        kw = dict(irreps_in=IRREPS, irreps_out=IRREPS, irreps_sh=SH, irreps_query=IRREPS,
                  irreps_key=IRREPS, edge_attr_dim=ATTR, n_head=HEADS)
        return JMultiheadAttention(**kw), MultiheadAttention(**kw)
    kw = dict(irreps_in=IRREPS, irreps_out=IRREPS, irreps_sh=SH, edge_attr_dim=ATTR, n_head=HEADS)
    return JTransformerBlock(**kw), TransformerBlock(**kw)


@functools.lru_cache(maxsize=None)
def _setup(name, padded):
    batch = PADDED if padded else FULL
    jb, tb = j_make_test_batch(**batch), make_test_batch(**batch, device="cpu")
    G, N = batch["num_graphs"], batch["max_nodes"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((G, N, Irreps(IRREPS).dim)).astype(np.float32)
    x *= np.asarray(tb.node_mask)[..., None]
    proj = rng.standard_normal(x.shape).astype(np.float32)
    jm, pm = _modules(name)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), _j_edges(jb, jb.pos))
    params = jax.tree.map(lambda p: p + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params)
    pm.load_state_dict(from_jax_params(params), strict=True)

    def jloss(p, xx, pos):
        return jnp.sum(jm.apply(p, xx, _j_edges(jb, pos)) * proj)

    want = np.asarray(jax.jit(lambda p, xx, pos: jm.apply(p, xx, _j_edges(jb, pos)))(params, x, jb.pos))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(params, jnp.asarray(x), jb.pos)
    return tb, x, proj, pm, want, jgrads


def _port_grads(pm, tb, x, proj):
    """The port's output and the gradients of sum(out * proj): parameters,
    features, positions."""
    pm.zero_grad()
    xt = torch.from_numpy(x).requires_grad_()
    pos = tb.pos.clone().requires_grad_()
    out = pm(xt, _edges(tb, pos))
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in pm.named_parameters()}, xt.grad, pos.grad


@pytest.mark.parametrize("name", ["MultiheadAttention", "TransformerBlock"])
def test_matches_jax_with_gradients(name):
    """Graphs without padding: output within 1e-5 of its max; gradients of
    sum(out * proj) in every parameter and the features within 1e-4 of each
    leaf's max; the position gradients finite (JAX's are NaN, see above)."""
    tb, x, proj, pm, want, (jg_p, jg_x, jg_pos) = _setup(name, padded=False)
    out, grads, gx, gpos = _port_grads(pm, tb, x, proj)
    assert out.shape == want.shape and np.abs(want).max() > 1e-2
    assert _rel(out.numpy(), want) < 1e-5
    jg = {k: v.numpy() for k, v in from_jax_params(jg_p).items()}
    assert sorted(grads) == sorted(jg)
    # the tree back to flax's: the same structure and leaves
    tree = to_jax_params(pm.state_dict())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jg_p)
    for n, g in grads.items():
        assert _rel(g.numpy(), jg[n]) < 1e-4, n
    assert _rel(gx.numpy(), np.asarray(jg_x)) < 1e-4
    assert torch.isfinite(gpos).all() and np.isnan(np.asarray(jg_pos)).any()


@pytest.mark.parametrize("name", ["MultiheadAttention", "TransformerBlock"])
def test_padded_graphs(name):
    """Padded graphs: the output within 1e-5 of JAX's; the port's gradients
    finite, where JAX's queries, keys and `dot_w` are NaN (ROADMAP.md §C),
    and the padded graph's own gradients (its features and positions, and
    every parameter) equal to those of the same atoms run unpadded, within
    1e-5 of each leaf's max."""
    tb, x, proj, pm, want, (jg_p, _, _) = _setup(name, padded=True)
    out, grads, gx, gpos = _port_grads(pm, tb, x, proj)
    assert _rel(out.numpy(), want) < 1e-5
    assert all(torch.isfinite(g).all() for g in (*grads.values(), gx, gpos))
    jg = from_jax_params(jg_p)
    dot_w = next(k for k in jg if k.endswith("dot_w"))
    assert torch.isnan(jg[dot_w]).any()  # JAX's fault, kept as JAX has it

    # graph 1 alone: its 6 real atoms at N = 6, and the same graph padded to 9
    n = PADDED["nodes_per_graph"][1]
    nb = int(tb.bond_mask[1].sum())
    one = make_test_batch(1, 9, nodes_per_graph=[n], max_bonds=16, device="cpu")
    one = dataclasses.replace(one, pos=tb.pos[1:], node_mask=tb.node_mask[1:], bond_src=tb.bond_src[1:],
                              bond_dst=tb.bond_dst[1:], bond_mask=tb.bond_mask[1:])
    cut = one.map(lambda t: t[:, :n] if t.dim() > 1 and t.shape[1] == 9 else t)
    cut = dataclasses.replace(cut, bond_src=tb.bond_src[1:, :nb], bond_dst=tb.bond_dst[1:, :nb],
                              bond_mask=tb.bond_mask[1:, :nb])
    o9, g9, gx9, gpos9 = _port_grads(pm, one, x[1:], proj[1:])
    o6, g6, gx6, gpos6 = _port_grads(pm, cut, x[1:, :n], proj[1:, :n])
    assert _rel(o9[:, :n].numpy(), o6.numpy()) < 1e-5
    assert _rel(gx9[:, :n].numpy(), gx6.numpy()) < 1e-5
    assert _rel(gpos9[:, :n].numpy(), gpos6.numpy()) < 1e-5
    for k in g6:
        assert _rel(g9[k].numpy(), g6[k].numpy()) < 1e-5, k


@pytest.mark.parametrize("name", ["MultiheadAttention", "TransformerBlock"])
def test_equivariant_and_padding_inert(name):
    """f(D x, R pos + t) = D f(x, pos) within 1e-5 of the max; padded atoms'
    features and positions do not reach the real atoms' outputs (equal bits
    after changing them)."""
    tb, x, _, pm, _, _ = _setup(name, padded=True)
    R = random_rotation(np.random.default_rng(6)).astype(np.float32)
    D = torch.from_numpy(Irreps(IRREPS).rotation_matrix(R).astype(np.float32))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = pm(xt, _edges(tb, tb.pos))
        rot = pm(xt @ D.T, _edges(tb, tb.pos @ torch.from_numpy(R).T + 0.3))
        assert _rel(rot.numpy(), (out @ D.T).numpy()) < 1e-5
        pad = ~tb.node_mask
        x2 = torch.where(pad[..., None], torch.full_like(xt, 7.0), xt)
        pos2 = torch.where(pad[..., None], torch.full_like(tb.pos, 0.01), tb.pos)
        out2 = pm(x2, _edges(tb, pos2))
    real = tb.node_mask
    assert torch.equal(out2[real], out[real])


def test_split_irreps_and_heads():
    """`split_irreps` as JAX's: the heads side by side; a multiplicity the
    heads do not divide raises."""
    split, head = split_irreps(IRREPS, 2)
    assert (str(split), str(head)) == ("4x0e + 2x1e + 4x0e + 2x1e", "4x0e + 2x1e")
    with pytest.raises(ValueError, match="heads"):
        split_irreps("6x0e + 3x1e", 2)
