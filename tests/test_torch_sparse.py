"""The sparse capped-neighbour path of the port against JAX (CPU, f32).

JAX side: `jamun_tpu/ops/neighbors.py`, `fast_uvu_messages_nbr`, the TPU
kernels `nbr_uvu_conv` and `nbr_edge_features` in interpret mode, and
`E3Conv(neighbor_mode="nbr")` on its kernel path (`use_pallas=True`) and its
XLA path. Port side: `ops/neighbors.py`, K6's and K7's plain twins (the
wrappers take them for CPU tensors) and the model's dispatch around them.
Inputs come from numpy seeds on worm-like-chain positions
(`make_chain_positions`) and cross over as numpy arrays; weights are JAX's
init perturbed with seeded noise and cross over with `from_jax_params`.
Tolerances are relative to the reference's largest value: 1e-5 unless a
check states its own. `torch.topk` may order tied slots differently from
`lax.top_k`, so lists are compared as sets per row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops import neighbors as jnbr
from jamun_tpu.ops.fast_uvu import fast_uvu_messages_nbr as j_messages_nbr
from jamun_tpu.ops.pallas.nbr_conv import nbr_edge_features as j_nbr_edge_features
from jamun_tpu.ops.pallas.nbr_conv import nbr_uvu_conv as j_nbr_uvu_conv
from jamun_tpu.ops.radial import soft_one_hot_linspace as j_soft_one_hot
from jamun_tpu.ops.sh import spherical_harmonics as j_sh
from jamun_tpu.sampling.mcmc import BAOAB as JBAOAB, MCMCConfig as JMCMCConfig
from jamun_tpu.sampling.mcmc import make_processed_score_fn as j_processed
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops import neighbors as tnbr
from jamun_tpu_torch.ops.cuda import nbr_conv as k6
from jamun_tpu_torch.ops.cuda import nbr_edge_features as k7
from jamun_tpu_torch.ops.fast_uvu import fast_uvu_messages_nbr
from jamun_tpu_torch.ops.radial import soft_one_hot_linspace
from jamun_tpu_torch.ops.sh import spherical_harmonics
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.sampling.mcmc import (
    BAOAB,
    MCMCConfig,
    NeighborCachedScore,
    VerletListScore,
    make_processed_score_fn,
)
from jamun_tpu_torch.sampling.sampler import Sampler
from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
from jamun_tpu_torch.utils.testing import make_chain_positions, make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
SH = "1x0e + 1x1e"
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")
CHAIN = dict(num_graphs=2, max_nodes=40, nodes_per_graph=[40, 33], max_bonds=80)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _chain(kw=CHAIN, seed=0):
    """The JAX and port batches of `kw` at chain positions (padding zero)."""
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    pos = make_chain_positions(kw["num_graphs"], kw["max_nodes"], seed=seed)
    pos = pos * np.asarray(jb.node_mask)[..., None]
    return jb.replace(pos=jnp.asarray(pos)), tb.replace_pos(torch.from_numpy(pos))


def _row_sets(idx, mask):
    idx, mask = np.asarray(idx), np.asarray(mask) > 0
    return [[set(idx[g, i][mask[g, i]].tolist()) for i in range(idx.shape[1])] for g in range(idx.shape[0])]


def _by_source(idx, mask, feats):
    """{(g, i, src): feature row} over the kept slots."""
    idx, mask, feats = np.asarray(idx), np.asarray(mask) > 0, np.asarray(feats, np.float64)
    return {(g, i, int(idx[g, i, k])): feats[g, i, k] for g, i, k in zip(*np.nonzero(mask))}


@pytest.mark.parametrize("cap", [4, 32])
def test_capped_lists_match_jax(cap):
    """Row sets, mask and overflow exactly, at a cap that overflows (4) and
    one that does not (32), on the same distance panel."""
    jb, tb = _chain()
    cutoff = 0.5
    j_idx, j_mask, j_over = jnbr.capped_neighbor_lists(jb.pos, jb.node_mask, cutoff, cap)
    t_idx, t_mask, t_over = tnbr.capped_neighbor_lists(tb.pos, tb.node_mask, cutoff, cap)
    assert t_idx.shape == tuple(j_idx.shape) and t_idx.dtype == torch.int64
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_over.numpy(), np.asarray(j_over))
    assert _row_sets(t_idx, t_mask) == _row_sets(j_idx, j_mask)
    if cap == 4:
        assert int(t_over.min()) > 0  # the cap drops edges in every graph
    else:
        assert int(t_over.max()) == 0 and int(t_mask.sum()) > 0


def _j_attr(bond, cutoff, radial_dim=32):
    def attr_fn(dist, bonded):
        radial = j_soft_one_hot(dist, 0.0, cutoff, radial_dim, basis="gaussian", cutoff=True)
        b = jnp.broadcast_to(bond[1 if bonded else 0], dist.shape + (bond.shape[-1],))
        return jnp.concatenate([b, radial], axis=-1)

    return attr_fn


def _t_attr(bond, cutoff, radial_dim=32):
    def attr_fn(dist, bonded):
        radial = soft_one_hot_linspace(dist, 0.0, cutoff, radial_dim)
        b = bond[1 if bonded else 0].expand(dist.shape + (bond.shape[-1],))
        return torch.cat([b, radial], dim=-1)

    return attr_fn


@pytest.mark.parametrize("cached", [False, True], ids=["built", "cached"])
def test_neighbor_edge_data_matches_jax(cached):
    """`neighbor_edge_data` with the list built at this forward and with a
    cache (a superset list built within cutoff + 0.3): the kept edges, their
    SH and attributes (matched by source), the overflow and the bond set."""
    jb, tb = _chain()
    cutoff, cap = 0.5, 8
    bond = np.random.default_rng(0).standard_normal((2, 32)).astype(np.float32)
    cache_j = cache_t = None
    if cached:
        j_idx, j_sup, _ = jnbr.capped_neighbor_lists(jb.pos, jb.node_mask, cutoff + 0.3, cap)
        cache_j = (j_idx, j_sup)
        cache_t = (torch.tensor(np.asarray(j_idx)).long(), torch.tensor(np.asarray(j_sup)))
    je, j_over = jnbr.neighbor_edge_data(
        jb.pos, jb.node_mask, jb.bond_src, jb.bond_dst, jb.bond_mask, cutoff,
        sh_fn=lambda v: j_sh(SH, v), attr_fn=_j_attr(jnp.asarray(bond), cutoff), cap=cap,
        cache=cache_j,
    )
    te, t_over = tnbr.neighbor_edge_data(
        tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, cutoff,
        lambda v: spherical_harmonics(SH, v), _t_attr(torch.from_numpy(bond), cutoff), cap=cap,
        cache=cache_t,
    )
    assert te.sh_dense is None and te.adj is None
    if cached:
        assert t_over is None and j_over is None
    else:
        np.testing.assert_array_equal(t_over.numpy(), np.asarray(j_over))
    assert _row_sets(te.nbr_idx, te.nbr_mask) == _row_sets(je.nbr_idx, je.nbr_mask)
    assert int(te.nbr_mask.sum()) > 0
    for field in ("sh_nbr", "attr_nbr"):
        got = _by_source(te.nbr_idx, te.nbr_mask, getattr(te, field))
        want = _by_source(je.nbr_idx, je.nbr_mask, getattr(je, field))
        assert got.keys() == want.keys()
        keys = sorted(want)
        assert _rel([got[k] for k in keys], [want[k] for k in keys]) < 1e-5, field
    assert _rel(te.attr_bond.numpy(), je.attr_bond) < 1e-5
    assert _rel(te.sh_bond.numpy(), je.sh_bond) < 1e-5


def _slot_inputs(S, V, A, seed=0, G=2, N=24, K=8):
    """Random K6 inputs: features, SH, attributes, a list with about half of
    its slots kept, and radial weights."""
    rng = np.random.default_rng(seed)
    W = 2 * S + 3 * V
    v = rng.standard_normal((G, N, K, 3)).astype(np.float32)
    sh = np.concatenate([np.ones((G, N, K, 1), np.float32),
                         np.sqrt(3) * v / np.linalg.norm(v, axis=-1, keepdims=True)], -1)
    return dict(
        x=rng.standard_normal((G, N, S + 3 * V)).astype(np.float32),
        sh=sh.astype(np.float32),
        attr=rng.standard_normal((G, N, K, A)).astype(np.float32),
        idx=rng.integers(0, N, (G, N, K)).astype(np.int32),
        mask=(rng.random((G, N, K)) < 0.5).astype(np.float32),
        w1=(rng.standard_normal((A, 64)) / np.sqrt(A)).astype(np.float32),
        b1=rng.standard_normal(64).astype(np.float32) * 0.1,
        w2=(rng.standard_normal((64, W)) / 8.0).astype(np.float32),
        b2=rng.standard_normal(W).astype(np.float32) * 0.1,
    )


def _torch(inp):
    out = {k: torch.from_numpy(v) for k, v in inp.items()}
    out["idx"] = out["idx"].long()
    return out


def test_fast_uvu_messages_nbr_matches_jax():
    """The plain sparse messages (the training path) against JAX's, and K6's
    plain twin against both."""
    S, V = 16, 8
    inp = _slot_inputs(S, V, 64, seed=1)
    w = np.random.default_rng(2).standard_normal(inp["attr"].shape[:3] + (2 * S + 3 * V,))
    w = w.astype(np.float32)
    j_out, j_deg = j_messages_nbr(inp["x"], inp["sh"], w, inp["idx"], inp["mask"], S=S, V=V)
    t = _torch(inp)
    t_out, t_deg = fast_uvu_messages_nbr(t["x"], t["sh"], torch.from_numpy(w), t["idx"], t["mask"], S, V)
    assert _rel(t_out.numpy(), j_out) < 1e-5
    np.testing.assert_array_equal(t_deg.numpy(), np.asarray(j_deg))


@pytest.mark.parametrize("A", [64, 32])
@pytest.mark.parametrize("sv", [(16, 8), (24, 0)], ids=["hidden", "projector"])
def test_nbr_conv_plain_matches_tpu_kernel(sv, A):
    """K6's plain twin against `nbr_uvu_conv(interpret=True)`, f32, for V > 0
    and V = 0, the whole attributes (A = 64) and the radial half (A = 32).
    The TPU kernel gathers by one-hot matmuls and sums K in another order:
    1e-5 of the max; the degree exactly."""
    S, V = sv
    inp = _slot_inputs(S, V, A, seed=3)
    j_out, j_deg = j_nbr_uvu_conv(
        jnp.asarray(inp["x"]), inp["sh"], inp["attr"], inp["idx"], inp["mask"], inp["w1"],
        inp["b1"], inp["w2"], inp["b2"], S=S, V=V, interpret=True,
    )
    t = _torch(inp)
    t_out, t_deg = k6.nbr_uvu_conv(
        t["x"], t["sh"], t["attr"], t["idx"], t["mask"], t["w1"], t["b1"], t["w2"], t["b2"], S, V
    )
    assert t_out.dtype == torch.float32 and t_out.shape == tuple(j_out.shape)
    assert _rel(t_out.numpy(), j_out) < 1e-5
    np.testing.assert_array_equal(t_deg.numpy(), np.asarray(j_deg))


def test_nbr_edge_features_plain_matches_tpu_kernel():
    """K7's plain twin against `nbr_edge_features(interpret=True)` on a cached
    superset list: the true-cutoff mask and the kept slots' indices exactly,
    SH and radial values on the kept slots within 1e-5 (the port takes
    sqrt(3) d * (1 / dist), the TPU kernel d * (sqrt(3) / dist)). Masked
    slots fold to the sentinel N here, to the padded N of the TPU kernel."""
    jb, tb = _chain()
    cutoff = 0.5
    j_idx, j_sup, _ = jnbr.capped_neighbor_lists(jb.pos, jb.node_mask, cutoff + 0.3, 16)
    j_sh4, j_rad, j_mask, j_idxf = j_nbr_edge_features(
        jb.pos, j_idx, j_sup, cutoff, n_radial=32, interpret=True
    )
    idx = torch.tensor(np.asarray(j_idx)).long()
    t_sh4, t_rad, t_mask, t_idxf = k7.nbr_edge_features(
        tb.pos, idx, torch.tensor(np.asarray(j_sup)), cutoff, 32, torch.float32
    )
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    kept = t_mask.numpy() > 0
    assert 0 < kept.sum() < np.asarray(j_sup).sum()  # the skin's extra slots are masked out
    np.testing.assert_array_equal(t_idxf.numpy()[kept], np.asarray(j_idxf)[kept])
    assert (t_idxf.numpy()[~kept] == 40).all()
    assert _rel(t_sh4.numpy()[kept], np.asarray(j_sh4)[kept]) < 1e-5
    assert _rel(t_rad.numpy()[kept], np.asarray(j_rad)[kept]) < 1e-5
    # the plain cached path sees the same kept edges
    te, _ = tnbr.neighbor_edge_data(
        tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, cutoff,
        lambda v: spherical_harmonics(SH, v), _t_attr(torch.zeros(2, 32), cutoff), cap=16,
        cache=(idx, torch.tensor(np.asarray(j_sup))),
    )
    np.testing.assert_array_equal(te.nbr_mask.numpy(), t_mask.numpy())


def _models(n_layers=2, cap=8, kw=CHAIN, seed=0, **jkw):
    """A JAX E3Conv (neighbor_mode="nbr") with perturbed params, the port's
    kernel-path and plain-path twins, and both batches."""
    jb, tb = _chain(kw, seed)
    arch = dict(ARCH, n_layers=n_layers)
    jm = JE3Conv(**arch, neighbor_mode="nbr", neighbor_cap=cap, **jkw)
    params = JDenoiser(jm, JConfig(1.0, 0.5)).init(jax.random.PRNGKey(seed), jb)
    rng = np.random.default_rng(100 + seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )
    ports = {}
    for name, extra in (("kernel", {}), ("plain", {"plain": True})):
        m = E3Conv(**arch, neighbor_mode="nbr", neighbor_cap=cap, device="cpu", **extra)
        m.load_state_dict(from_jax_params(params), strict=True)
        ports[name] = m.requires_grad_(False)
    return params, jb, tb, ports


@pytest.mark.parametrize("cached", [False, True], ids=["built", "cached"])
@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_e3conv_nbr_matches_jax(path, cached):
    """`E3Conv(neighbor_mode="nbr")`, its output and the overflow telemetry:
    the port's kernel path (K6's twin) against JAX with `use_pallas=True`
    (`nbr_uvu_conv` in interpret mode), the plain path against JAX's XLA
    path, each with the list of this forward and with a cache."""
    params, jb, tb, ports = _models()
    jm = JE3Conv(**ARCH, neighbor_mode="nbr", neighbor_cap=8, use_pallas=path == "kernel")
    c_noise = np.asarray([-0.8], np.float32)
    cutoff = 0.6
    jcache = tcache = None
    if cached:
        j_idx, j_sup, _ = jnbr.capped_neighbor_lists(jb.pos, jb.node_mask, cutoff + 0.2, 8)
        jcache = (j_idx, j_sup)
        tcache = (torch.tensor(np.asarray(j_idx)).long(), torch.tensor(np.asarray(j_sup)))
    want, inter = jm.apply(params, jb, jnp.asarray(c_noise), cutoff, nbr_cache=jcache,
                           mutable=["intermediates"])
    got, tel = ports[path](tb, torch.from_numpy(c_noise), cutoff, nbr_cache=tcache,
                           with_telemetry=True)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    assert _rel(got.numpy(), want) < 1e-5
    sown = inter.get("intermediates", {}).get("neighbor_overflow")
    if cached:
        assert sown is None and tel == {}
    else:
        np.testing.assert_array_equal(tel["neighbor_overflow"].numpy(), np.asarray(sown[0]))


def test_e3conv_nbr_geom_kernel_matches_jax(monkeypatch):
    """`E3Conv(nbr_geom_kernel=True)` with a cache (K7's twin, then K6's twin
    on the radial half with the bondedness block folded into b1) against
    JAX's kernel path with `JAMUN_NBR_GEOM_KERNEL=1`; without a cache, or
    with a gradient wanted, the flag changes nothing."""
    monkeypatch.setenv("JAMUN_NBR_GEOM_KERNEL", "1")
    params, jb, tb, ports = _models()
    jm = JE3Conv(**ARCH, neighbor_mode="nbr", neighbor_cap=8, use_pallas=True)
    c_noise = np.asarray([-0.8], np.float32)
    cutoff = 0.6
    j_idx, j_sup, _ = jnbr.capped_neighbor_lists(jb.pos, jb.node_mask, cutoff + 0.2, 8)
    tcache = (torch.tensor(np.asarray(j_idx)).long(), torch.tensor(np.asarray(j_sup)))
    want = jm.apply(params, jb, jnp.asarray(c_noise), cutoff, nbr_cache=(j_idx, j_sup))
    model = ports["kernel"]
    model.nbr_geom_kernel = True
    calls = []
    monkeypatch.setattr("jamun_tpu_torch.models.e3conv.nbr_edge_features",
                        lambda *a, **k: calls.append(1) or k7.nbr_edge_features(*a, **k))
    got = model(tb, torch.from_numpy(c_noise), cutoff, nbr_cache=tcache)
    assert calls == [1]
    assert _rel(got.numpy(), want) < 1e-5
    model(tb, torch.from_numpy(c_noise), cutoff)
    model.requires_grad_(True)
    model(tb, torch.from_numpy(c_noise), cutoff, nbr_cache=tcache)
    assert calls == [1]


def test_auto_n512_matches_jax():
    """`neighbor_mode="auto"` at N = 512 without a gradient resolves to the
    sparse path on both sides: the port's kernel path (K6's twin) against
    JAX's XLA sparse path, one hidden layer, the default cap. The sparse
    path adds no parameter: the same JAX tree drives the dense path too."""
    kw = dict(num_graphs=1, max_nodes=512, nodes_per_graph=[512], max_bonds=1024)
    jb, tb = _chain(kw, seed=1)
    arch = dict(ARCH, n_layers=1)
    jm = JE3Conv(**arch, use_pallas=False)
    params = JDenoiser(jm, JConfig(1.0, 0.5)).init(jax.random.PRNGKey(1), jb)
    rng = np.random.default_rng(7)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )
    model = E3Conv(**arch, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    model.requires_grad_(False)
    c_noise = np.asarray([-0.8], np.float32)
    want, inter = jm.apply(params, jb, jnp.asarray(c_noise), 0.7, mutable=["intermediates"])
    assert "neighbor_overflow" in inter["intermediates"]  # JAX went sparse too
    got, tel = model(tb, torch.from_numpy(c_noise), 0.7, with_telemetry=True)
    assert "neighbor_overflow" in tel
    assert _rel(got.numpy(), want) < 1e-5
    dense = E3Conv(**arch, neighbor_mode="dense", device="cpu").requires_grad_(False)
    dense.load_state_dict(from_jax_params(params), strict=True)
    want = JE3Conv(**arch, use_pallas=False, neighbor_mode="dense").apply(
        params, jb, jnp.asarray(c_noise), 0.7
    )
    got, tel = dense(tb, torch.from_numpy(c_noise), 0.7, with_telemetry=True)
    assert tel == {} and _rel(got.numpy(), want) < 1e-5


def _denoisers(cap=8):
    params, jb, tb, ports = _models(cap=cap)
    jden = JDenoiser(JE3Conv(**ARCH, neighbor_mode="nbr", neighbor_cap=cap), JConfig(1.0, 0.5))
    return jden, params, jb, Denoiser(ports["kernel"], DenoiserConfig(1.0, 0.5)), tb


def test_cached_walk_matches_jax():
    """Four BAOAB steps on Verlet lists (skin 0.02 nm, so the displacement
    trigger fires within the walk) with the same injected Gaussian draws:
    y, v and both scores within 1e-4 of their max at every step, and the
    rebuilds on the same steps (y_ref moves on the same steps and agrees)."""
    jden, params, jb, den, tb = _denoisers()
    skin = 0.02
    cfg_kw = dict(delta=0.04, friction=1.0, M=1.0, steps=5, score_fn_clip=50.0)
    jcfg, cfg = JMCMCConfig(**cfg_kw), MCMCConfig(**cfg_kw)
    rng = np.random.default_rng(9)
    draws = [rng.standard_normal(jb.pos.shape).astype(np.float32) for _ in range(4)]
    it = iter(draws)
    jcached = jden.make_neighbor_cached_score(params, jb, SIGMA, skin)
    jproc = j_processed(None, 1.0, 50.0, cached=jcached)
    with torch.no_grad():
        tcached = den.make_neighbor_cached_score(tb, SIGMA, skin)
        lists = VerletListScore(tcached, tb.pos)
        tproc = make_processed_score_fn(lists, 1.0, 50.0)
        v0 = torch.from_numpy(rng.standard_normal(jb.pos.shape).astype(np.float32))
        carry = (tb.pos, v0, *tproc(tb.pos))
        aux0 = (jcached.rebuild(jb.pos), jb.pos)
        jpsi, jorig, aux = jproc(jb.pos, aux0)
        jcarry = (jb.pos, jnp.asarray(v0.numpy()), jpsi, jorig, aux)
        sampler = BAOAB(cfg)
        damp, zeta2 = np.exp(-1.0), np.sqrt(1.0 - np.exp(-2.0))
        fired = []
        for R in draws:
            t_ref, j_ref = lists.y_ref, jcarry[4][1]
            carry = sampler.step(carry, torch.from_numpy(R), tproc)
            jcarry = JBAOAB._step(
                jcarry, None, jproc, jcfg, damp, zeta2, 1.0, lambda k, s, d: jnp.asarray(next(it))
            )
            for a, b in zip(carry, jcarry[:4]):
                assert _rel(a.numpy(), np.asarray(b)) < 1e-4
            fired.append(not torch.equal(lists.y_ref, t_ref))
            assert fired[-1] == (not np.array_equal(np.asarray(jcarry[4][1]), np.asarray(j_ref)))
            assert _rel(lists.y_ref.numpy(), jcarry[4][1]) < 1e-5
    assert int(tcached.rebuilds) == sum(fired) >= 1  # the trigger fired


def test_cached_machinery_and_rebuild_trigger():
    """`tests/test_neighbor_cache.py`'s cases on the port: a cached score
    that ignores its cache reproduces the plain walk exactly (same
    generator); threshold inf freezes the list at the first build and
    threshold 0 rebuilds at every step (a spring anchored at the cached
    positions tells them apart)."""
    y0 = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 3)).astype(np.float32))
    mcmc = BAOAB(MCMCConfig(delta=0.1, friction=1.0, steps=20, save_every_n_steps=5))
    ref = mcmc(y0, lambda y: -y, torch.Generator().manual_seed(1), v_init="gaussian")
    cached = NeighborCachedScore(rebuild=lambda y: (torch.zeros(()),), score=lambda y, c: -y,
                                 threshold=0.05)
    out = mcmc(y0, None, torch.Generator().manual_seed(1), v_init="gaussian", cached_score=cached)
    for a, b in zip(ref, out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(cached.rebuilds) > 0

    cfg = MCMCConfig(delta=0.05, friction=1.0, steps=30, save_every_n_steps=29)

    def run(threshold):
        c = NeighborCachedScore(rebuild=lambda y: (y,), score=lambda y, cache: cache[0] - y,
                                threshold=threshold)
        y = BAOAB(cfg)(torch.ones(1, 4, 3), None, torch.Generator().manual_seed(2), v_init="zero",
                       cached_score=c)[0]
        return y, int(c.rebuilds)

    (frozen, n_frozen), (fresh, n_fresh) = run(1e9), run(0.0)
    assert n_frozen == 0 and n_fresh == 29
    assert not torch.allclose(frozen, fresh)


def test_walk_skin_on_the_sparse_path():
    """`SingleMeasurementSampler(neighbor_skin=...)` runs the walk on Verlet
    lists where the model is sparse (the output counts the rebuilds) and is
    a no-op on a dense model; an uncapped list (K = N) walked with a wide
    skin agrees with the uncached walk to rounding, as JAX's slow test
    checks."""
    _, _, _, den, tb = _denoisers(cap=40)
    cfg = MCMCConfig(delta=0.02, friction=1.0, steps=12, save_every_n_steps=4, score_fn_clip=100.0)
    plain = SingleMeasurementSampler(BAOAB(cfg), SIGMA)
    cached = SingleMeasurementSampler(BAOAB(cfg), SIGMA, neighbor_skin=3.0)
    a = plain.walk(den, tb, tb.pos, torch.Generator().manual_seed(4))
    b = cached.walk(den, tb, tb.pos, torch.Generator().manual_seed(4))
    assert "neighbor_rebuilds" not in a and int(b["neighbor_rebuilds"]) == 0
    torch.testing.assert_close(b["y_traj"], a["y_traj"], rtol=0, atol=2e-4)
    dense = Denoiser(E3Conv(**ARCH, neighbor_mode="dense", device="cpu", seed=0), den.config)
    assert dense.make_neighbor_cached_score(tb, SIGMA, 0.3) is None
    assert den.make_neighbor_cached_score(tb, SIGMA, 0.0) is None
    out = cached.walk(dense, tb, tb.pos, torch.Generator().manual_seed(4))
    assert "neighbor_rebuilds" not in out


def test_training_loss_gradients_on_the_sparse_path():
    """`training_loss` on the sparse path (a gradient is wanted: the plain
    sparse path, as JAX's `training=True`) against JAX's, with the same
    noise (`add_fixed_ones`): the loss, every gradient leaf within 1e-4 of
    its max, and the overflow aux (mean and max over valid graphs)."""
    params, jb, tb, ports = _models(cap=4)
    jcfg = JConfig(1.0, 0.5, add_fixed_ones=True)
    jden = JDenoiser(JE3Conv(**ARCH, neighbor_mode="nbr", neighbor_cap=4), jcfg)
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        lambda p: jden.training_loss(p, jax.random.PRNGKey(0), jb, SIGMA), has_aux=True
    )(params)
    model = ports["plain"]
    model.plain = False  # the dispatch picks the plain sparse path for a call that wants a gradient
    model.requires_grad_(True)
    den = Denoiser(model, DenoiserConfig(1.0, 0.5, add_fixed_ones=True))
    loss, aux = den.training_loss(tb, SIGMA, torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for k in ("neighbor_overflow_mean", "neighbor_overflow_max"):
        assert float(aux[k]) == float(j_aux[k]) and float(aux[k]) > 0
    flat = {".".join(k.key for k in path[1:]): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in model.named_parameters()}
    assert set(got) == set(flat)
    live = [n for n, g in flat.items() if np.abs(g).max() > 0]
    assert len(live) >= len(flat) - 4
    for name in live:
        assert _rel(got[name], flat[name]) < 1e-4, name


def test_sampler_overflow_telemetry():
    """`Sampler.sample` reports, per batch, the mean and max over the valid
    graphs of the edges the cap drops at the batch's end positions, which
    is JAX's `neighbor_overflow` on those positions, as JAX's `Sampler`
    reports it (`jamun_tpu/sampling/sampler.py:140-205`); a dense model
    reports None."""
    jden, _, jb, den, tb = _denoisers(cap=4)
    tb = dataclasses.replace(tb, graph_mask=torch.tensor([True, False]))
    seen = []

    class Record:
        def on_after_sample_batch(self, sample, sampler, elapsed_seconds, neighbor_overflow):
            seen.append((sample, neighbor_overflow))

    smp = SingleMeasurementSampler(BAOAB(MCMCConfig(delta=0.04, steps=3, score_fn_clip=50.0)), SIGMA)
    Sampler(callbacks=[Record()], device="cpu").sample(den, smp, 2, tb, continue_chain=True, seed=0)
    assert len(seen) == 2
    for sample, overflow in seen:
        (entry,) = sample  # graph 1 is masked out
        y = np.zeros(tb.pos.shape, np.float32)
        y[0, : entry["num_atoms"]] = entry["y"]
        want = np.asarray(jden.neighbor_overflow(jb.replace(pos=jnp.asarray(y)), SIGMA))
        assert overflow == {"mean": float(want[0]), "max": int(want[0])} and want[0] > 0
    dense = Denoiser(E3Conv(**ARCH, neighbor_mode="dense", device="cpu", seed=0), den.config)
    seen.clear()
    Sampler(callbacks=[Record()], device="cpu").sample(dense, smp, 1, tb, seed=0)
    assert seen[0][1] is None


def test_sparse_walk_builds_no_tensor_from_the_host(monkeypatch):
    """Nothing around K6 and K7 in a score call on Verlet lists, the rebuild
    on the device included, makes a tensor from host data: on the card each
    such copy waits for every kernel queued before it. `spherical_harmonics`
    once indexed with a list (found by the card's sync debug mode when the
    sparse path first ran it there)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    v = torch.randn(5, 3)
    with Record():
        sh = spherical_harmonics(SH, v)
    torch.testing.assert_close(sh[:, 1:], np.sqrt(3) * (v / v.norm(dim=-1, keepdim=True))[:, [1, 2, 0]])
    assert "lift_fresh" not in ops, ops

    _, _, _, den, tb = _denoisers()
    den.arch.nbr_geom_kernel = True
    stub6 = lambda x, *a: (x.new_zeros(x.shape[:2] + (4 * a[-2] + 7 * a[-1],)).float(),  # noqa: E731
                           x.new_zeros(x.shape[:2]).float())
    monkeypatch.setattr("jamun_tpu_torch.ops.conv.nbr_uvu_conv", stub6)
    stub7 = lambda pos, idx, sup, cutoff, nr, cdt: (  # noqa: E731
        pos.new_zeros(idx.shape + (4,)), pos.new_zeros(idx.shape + (nr,)),
        pos.new_zeros(idx.shape), idx)
    monkeypatch.setattr("jamun_tpu_torch.models.e3conv.nbr_edge_features", stub7)
    with torch.no_grad():
        for geom in (False, True):
            den.arch.nbr_geom_kernel = geom
            lists = VerletListScore(den.make_neighbor_cached_score(tb, SIGMA, 0.02), tb.pos)
            lists(tb.pos)
            ops.clear()
            with Record():
                lists(tb.pos + 0.05)  # the trigger fires: a rebuild
                den.score(tb, SIGMA)  # the list of this forward
            assert len(ops) > 100
            assert not {"lift_fresh", "scalar_tensor", "_local_scalar_dense"} & set(ops), ops
