"""EquiFold's modules of the port (`jamun_tpu_torch/ops/contrib/equifold.py`)
against JAX's on the CPU in f32, at the widths of tests/test_equifold.py
(8 channels, 2 heads, G = 2, N = 12 with 12 and 9 valid atoms, a Bessel
radial network of 8 functions and 16 hidden): `SVLinear`, `SVLayerNorm`,
`BesselBasis`, `SinusoidalBasis`, `RadialNN` (both bases, with edge and time
features), `DTPByHead`, `Equiformer` and `Convnet`. The same inputs (seeded
numpy) go to both; the port's parameters are JAX's, perturbed by 0.3,
through `params.from_jax_params`. Outputs within 1e-5 of their max (1e-4
for the two blocks), gradients within 1e-4 of each leaf's max; padded atoms
must not reach the valid ones, and the attention rows sum to 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.ops.contrib import equifold as jeq
from jamun_tpu_torch.ops.contrib import equifold as eq
from jamun_tpu_torch.ops.wigner import random_rotation
from jamun_tpu_torch.params import from_jax_params, init_parameters, to_jax_params

torch.set_num_threads(2)
G, N, S, VALID = 2, 12, 8, (12, 9)
RADIAL = dict(rc=1.2, radial_num_basis=8, radial_num_hidden=16, radial_num_layers=2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _j_radial(num_out_features, name=None):
    return jeq.RadialNN(num_out_features=num_out_features, name=name, **RADIAL)


_radial = functools.partial(eq.RadialNN, **RADIAL)


def _inputs(valid=VALID, seed=0):
    """s, v, pos, node_mask, pair_mask (no self pairs), r, rvec, cutoff."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((G, N, 3)).astype(np.float32)
    s = rng.standard_normal((G, N, S)).astype(np.float32)
    v = rng.standard_normal((G, N, S, 3)).astype(np.float32)
    node_mask = np.zeros((G, N), bool)
    for g, n in enumerate(valid):
        node_mask[g, :n] = True
    pair_mask = node_mask[:, :, None] & node_mask[:, None, :] & ~np.eye(N, dtype=bool)[None]
    d = pos[:, :, None, :] - pos[:, None, :, :]
    r = np.sqrt((d * d).sum(-1) + 1e-12).astype(np.float32)
    rvec = (d / r[..., None]).astype(np.float32)
    return s, v, pos, node_mask, pair_mask, r, rvec, np.exp(-r).astype(np.float32)


def _pair(jmod, pmod, args, seed):
    """JAX's parameters (perturbed by 0.3) in both modules."""
    params = jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, args))
    rng = np.random.default_rng(100 + seed)
    params = jax.tree.map(lambda p: p + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params)
    pmod.load_state_dict(from_jax_params(params), strict=True)
    back = to_jax_params(pmod.state_dict())  # and back to flax's tree, leaf for leaf
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    return params


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def test_sv_modules_and_bases_match_jax():
    """SVLinear (with and without bias, no scalar output), SVLayerNorm,
    BesselBasis, SinusoidalBasis and RadialNN (both bases; the Bessel one
    with 3 edge and 2 time features): within 1e-5 of the max."""
    s, v, *_ , r, _, _ = _inputs()
    cases = [
        (jeq.SVLinear(S, 5, S, 3, add_bias=True), eq.SVLinear(S, 5, S, 3, add_bias=True), (s, v)),
        (jeq.SVLinear(S, 4, S, 6), eq.SVLinear(S, 4, S, 6), (s, v)),
        (jeq.SVLinear(S, 0, S, 6), eq.SVLinear(S, 0, S, 6), (s, v)),
        (jeq.SVLayerNorm(S, S), eq.SVLayerNorm(S, S), (3.0 * s + 2.0, 4.0 * v)),
        (jeq.BesselBasis(1.2, 6), eq.BesselBasis(1.2, 6), (r,)),
        (jeq.RadialNN(10, basis_type="sinusoidal", **RADIAL),
         eq.RadialNN(10, basis_type="sinusoidal", **RADIAL), (r,)),
    ]
    rng = np.random.default_rng(1)
    edges = rng.standard_normal(r.shape + (3,)).astype(np.float32)
    ts = rng.standard_normal(r.shape + (2,)).astype(np.float32)
    cases.append((jeq.RadialNN(10, **RADIAL), eq.RadialNN(10, num_edge_features=3, num_ts_features=2, **RADIAL),
                  (r, edges, ts)))
    for k, (jm, pm, args) in enumerate(cases):
        params = _pair(jm, pm, args, k)
        want = jm.apply(params, *map(jnp.asarray, args))
        with torch.no_grad():
            got = pm(*map(_t, args))
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        for w, g in zip(want, got):
            assert (w is None) == (g is None), k
            if w is not None:
                assert _rel(g.numpy(), w) < 1e-5, k
    sb = eq.SinusoidalBasis(2.0, 8)
    assert _rel(sb(_t(r)).numpy(), jeq.SinusoidalBasis(2.0, 8).apply({}, jnp.asarray(r))) < 1e-5
    assert list(sb.parameters()) == []


def test_dtp_by_head_matches_jax():
    """Head-grouped pairs [G, N, N, H, M] with external weights: within 1e-5."""
    H, M = 2, 4
    rng = np.random.default_rng(2)
    s = rng.standard_normal((G, N, N, H, M)).astype(np.float32)
    v = rng.standard_normal((G, N, N, H, M, 3)).astype(np.float32)
    rvec = _inputs()[6]
    jm, pm = jeq.DTPByHead(M, 3, 2, H), eq.DTPByHead(M, 3, 2, H)
    w = rng.standard_normal((G, N, N, pm.weight_numel)).astype(np.float32)
    assert pm.weight_numel == jm.weight_numel
    params = _pair(jm, pm, (s, v, rvec, w), 3)
    want = jm.apply(params, *map(jnp.asarray, (s, v, rvec, w)))
    with torch.no_grad():
        got = pm(*map(_t, (s, v, rvec, w)))
    for g, wnt in zip(got, want):
        assert _rel(g.numpy(), wnt) < 1e-5


def _block(name):
    if name == "equiformer":
        return (jeq.Equiformer(nc_s=S, nc_v=S, radial_nn=_j_radial, num_heads=2),
                eq.Equiformer(nc_s=S, nc_v=S, radial_nn=_radial, num_heads=2))
    return (jeq.Convnet(nc_s=S, nc_v=S, radial_nn=_j_radial, div_factor=3.0),
            eq.Convnet(nc_s=S, nc_v=S, radial_nn=_radial, div_factor=3.0))


@pytest.mark.parametrize("name", ["equiformer", "convnet"])
def test_block_matches_jax_with_gradients(name):
    """All atoms valid: (s, v) within 1e-4 of the max; gradients of a
    projection in every parameter and in s and v within 1e-4 of each
    leaf's max."""
    s, v, _, _, pair_mask, r, rvec, cutoff = _inputs(valid=(N, N), seed=4)
    jm, pm = _block(name)
    args = (s, v, pair_mask, r, rvec, cutoff)
    params = _pair(jm, pm, args, 5)
    rng = np.random.default_rng(6)
    ps, pv = rng.standard_normal(s.shape).astype(np.float32), rng.standard_normal(v.shape).astype(np.float32)

    def jloss(p, s_, v_):
        so, vo = jm.apply(p, s_, v_, *map(jnp.asarray, args[2:]))
        return jnp.sum(so * ps) + jnp.sum(vo * pv)

    jg, jgs, jgv = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(params, jnp.asarray(s), jnp.asarray(v))
    want = jax.jit(jm.apply)(params, *map(jnp.asarray, args))
    st, vt = _t(s).requires_grad_(), _t(v).requires_grad_()
    so, vo = pm(st, vt, *map(_t, args[2:]))
    assert _rel(so.detach().numpy(), want[0]) < 1e-4 and _rel(vo.detach().numpy(), want[1]) < 1e-4
    ((so * _t(ps)).sum() + (vo * _t(pv)).sum()).backward()
    jg = {k: t.numpy() for k, t in from_jax_params(jg).items()}
    assert sorted(jg) == sorted(n for n, _ in pm.named_parameters())
    for n, p in pm.named_parameters():
        assert _rel(p.grad.numpy(), jg[n]) < 1e-4, n
    assert _rel(st.grad.numpy(), jgs) < 1e-4 and _rel(vt.grad.numpy(), jgv) < 1e-4


@pytest.mark.parametrize("name", ["equiformer", "convnet"])
def test_block_padded_and_equivariant(name):
    """Padded graphs (12 and 9 valid atoms): the valid atoms' (s, v) within
    1e-4 of JAX's; changing the padded atoms' features and positions leaves
    them equal within 1e-6 of the max; the port's gradients are finite; and
    (s, v) rotate as scalars and vectors within 1e-5 of the max."""
    s, v, pos, node_mask, pair_mask, r, rvec, cutoff = _inputs(seed=7)
    jm, pm = _block(name)
    args = (s, v, pair_mask, r, rvec, cutoff)
    params = _pair(jm, pm, args, 8)
    want = jax.jit(jm.apply)(params, *map(jnp.asarray, args))
    st, vt = _t(s).requires_grad_(), _t(v).requires_grad_()
    so, vo = pm(st, vt, *map(_t, args[2:]))
    m = torch.from_numpy(node_mask)
    assert _rel(so.detach()[m].numpy(), np.asarray(want[0])[node_mask]) < 1e-4
    assert _rel(vo.detach()[m].numpy(), np.asarray(want[1])[node_mask]) < 1e-4
    (so.sum() + vo.sum()).backward()
    assert all(torch.isfinite(p.grad).all() for p in pm.parameters())
    assert torch.isfinite(st.grad).all() and torch.isfinite(vt.grad).all()
    with torch.no_grad():
        junk = np.random.default_rng(9).standard_normal(s.shape).astype(np.float32) * 1e3
        s2 = np.where(node_mask[..., None], s, junk)
        v2 = np.where(node_mask[..., None, None], v, junk[..., None])
        pos2 = np.where(node_mask[..., None], pos, 50.0 + pos)
        d = pos2[:, :, None] - pos2[:, None]
        r2 = np.sqrt((d * d).sum(-1) + 1e-12).astype(np.float32)
        so2, vo2 = pm(_t(s2), _t(v2), _t(pair_mask), _t(r2), _t(d / r2[..., None]), _t(np.exp(-r2)))
        assert _rel(so2[m].numpy(), so[m].detach().numpy()) < 1e-6
        assert _rel(vo2[m].numpy(), vo[m].detach().numpy()) < 1e-6
        R = torch.from_numpy(random_rotation(np.random.default_rng(10)).astype(np.float32))
        so3, vo3 = pm(st, vt @ R.T, _t(pair_mask), _t(r), _t(rvec) @ R.T, _t(cutoff))
        assert _rel(so3[m].numpy(), so[m].numpy()) < 1e-5
        assert _rel(vo3[m].numpy(), (vo @ R.T)[m].numpy()) < 1e-5


def test_attention_rows_normalize():
    """The masked softmax over sources: each row with a valid source sums to
    1, masked entries are 0, empty rows are all 0 (no NaN), and equal to
    JAX's within 1e-6."""
    z = np.random.default_rng(11).standard_normal((2, 5, 3, 5)).astype(np.float32)
    mask = (np.random.default_rng(0).random((2, 5, 1, 5)) > 0.4) | np.zeros((2, 5, 3, 5), bool)
    mask[0, 0] = False
    a = eq._masked_softmax_over_src(_t(z), _t(mask)).numpy()
    has_any = mask.any(-1)
    np.testing.assert_allclose(a.sum(-1)[has_any], 1.0, rtol=1e-5)
    assert (a[~mask] == 0).all() and np.isfinite(a).all() and not has_any.all()
    want = np.asarray(jeq._masked_softmax_over_src(jnp.asarray(z), jnp.asarray(mask)))
    np.testing.assert_allclose(a, want, atol=1e-6)


def test_init_parameters_draws_flax_distributions():
    """`params.init_parameters` on Equiformer: xavier-uniform weights within
    their bound, zero biases, unit layer-norm gains, the Bessel frequencies
    n pi; the same seed gives the same weights."""
    a = init_parameters(_block("equiformer")[1], 0)
    b = init_parameters(_block("equiformer")[1], 0)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.linear_dst.w_s
    assert 0 < float(w.detach().abs().max()) <= (6.0 / (2 * S)) ** 0.5
    assert not a.linear_dst.b_s.any() and torch.equal(a.layer_norm_ff.gamma_s, torch.ones(S))
    torch.testing.assert_close(a.RadialNN_0.BesselBasis_0.bessel_weights,
                               torch.arange(1, 9, dtype=torch.float32) * np.pi)
    dense = a.RadialNN_0.Dense_0  # xavier [8, 16], zero bias
    assert 0 < float(dense.kernel.detach().abs().max()) <= (6.0 / 24) ** 0.5 and not dense.bias.any()
