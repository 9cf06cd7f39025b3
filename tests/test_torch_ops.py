"""The PyTorch port's layer ops against their JAX counterparts (CPU, f32).

Inputs come from numpy seeds and go through both packages; parameters are
made by the JAX modules' `init`, perturbed with seeded numpy noise, and
loaded into the port through `jamun_tpu_torch.params.from_jax_params`.
Tolerance: f32 on both sides with JAX at "highest" matmul precision, so
the only differences are summation order: 1e-5 relative and absolute
unless a test says otherwise.
"""

import functools
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.embeddings import AtomEmbeddingWithResidueInformation as JEmbed
from jamun_tpu.models.noise_conditioning import (
    NoiseConditionalScaling as JScaling,
    NoiseConditionalSkipConnection as JSkip,
)
from jamun_tpu.ops.conv import ConvBlock as JConvBlock
from jamun_tpu.ops.fast_uvu import fast_uvu_messages_dense as j_fast_uvu
from jamun_tpu.ops.gate import Gate as JGate
from jamun_tpu.ops.graph import dense_edge_data as j_dense_edge_data
from jamun_tpu.ops.linear import IrrepsLinear as JLinear
from jamun_tpu.ops.mlp import EquivariantMLP as JEqMLP
from jamun_tpu.ops.radial import soft_one_hot_linspace as j_radial
from jamun_tpu.ops.sh import spherical_harmonics as j_sh
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.embeddings import AtomEmbeddingWithResidueInformation
from jamun_tpu_torch.models.noise_conditioning import (
    NoiseConditionalScaling,
    NoiseConditionalSkipConnection,
)
from jamun_tpu_torch.ops.conv import ConvBlock
from jamun_tpu_torch.ops.fast_uvu import fast_uvu_messages_dense
from jamun_tpu_torch.ops.gate import Gate
from jamun_tpu_torch.ops.graph import dense_edge_data
from jamun_tpu_torch.ops.linear import IrrepsLinear
from jamun_tpu_torch.ops.mlp import EquivariantMLP
from jamun_tpu_torch.ops.radial import soft_one_hot_linspace
from jamun_tpu_torch.ops.sh import spherical_harmonics
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_arrays, make_test_batch

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SH = "1x0e + 1x1e"
REPO = pathlib.Path(__file__).resolve().parents[1]


def perturb(params, seed=0, scale=0.1):
    """Every leaf + seeded numpy noise (output gains and identity-initialised
    layers stop being trivial)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def load(module, jax_params):
    module.load_state_dict(from_jax_params(jax_params), strict=True)
    return module


def t(a):
    return torch.from_numpy(np.asarray(a))


def batches(n_nodes=16, nodes_per_graph=(14, 16)):
    jb = j_make_test_batch(num_graphs=2, max_nodes=n_nodes, nodes_per_graph=list(nodes_per_graph))
    tb = make_test_batch(
        num_graphs=2, max_nodes=n_nodes, nodes_per_graph=list(nodes_per_graph), device="cpu"
    )
    return jb, tb


def test_make_test_batch_matches_jax():
    jb = j_make_test_batch(num_graphs=3, max_nodes=9, max_bonds=12, seed=4)
    arrays = make_test_arrays(num_graphs=3, max_nodes=9, max_bonds=12, seed=4)
    for k, a in arrays.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jb, k)), err_msg=k)


def test_make_chain_positions_matches_jax():
    from jamun_tpu.utils.testing import make_chain_positions as j_chain
    from jamun_tpu_torch.utils.testing import make_chain_positions

    np.testing.assert_array_equal(make_chain_positions(3, 12, seed=5), np.asarray(j_chain(3, 12, seed=5)))


def test_spherical_harmonics():
    v = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    v[0] = 0.0  # the eps clamp
    np.testing.assert_allclose(
        spherical_harmonics(SH, t(v)).numpy(), np.asarray(j_sh(SH, jnp.asarray(v))), **TOL
    )


def test_radial_basis():
    x = np.random.default_rng(1).uniform(0, 1.2, (7, 5)).astype(np.float32)
    np.testing.assert_allclose(
        soft_one_hot_linspace(t(x), 0.0, 0.9, 32).numpy(),
        np.asarray(j_radial(jnp.asarray(x), 0.0, 0.9, 32, basis="gaussian", cutoff=True)),
        **TOL,
    )


def _attr_fns(bond_embed):
    def j_attr(dist, bonded):
        r = j_radial(dist, 0.0, 0.8, 32, basis="gaussian", cutoff=True)
        b = jnp.broadcast_to(jnp.asarray(bond_embed[int(bonded)]), dist.shape + (32,))
        return jnp.concatenate([b, r], -1)

    def t_attr(dist, bonded):
        r = soft_one_hot_linspace(dist, 0.0, 0.8, 32)
        b = t(bond_embed[int(bonded)]).expand(dist.shape + (32,))
        return torch.cat([b, r], -1)

    return j_attr, t_attr


def _edges(jb, tb, bond_embed):
    j_attr, t_attr = _attr_fns(bond_embed)
    je = j_dense_edge_data(
        jnp.asarray(jb.pos), jnp.asarray(jb.node_mask), jnp.asarray(jb.bond_src),
        jnp.asarray(jb.bond_dst), jnp.asarray(jb.bond_mask), 0.8,
        functools.partial(j_sh, SH), j_attr, dense=True,
        bond0_embed=jnp.asarray(bond_embed[0]), bond1_embed=jnp.asarray(bond_embed[1]),
    )
    te = dense_edge_data(
        tb.pos, tb.node_mask, tb.bond_src, tb.bond_dst, tb.bond_mask, 0.8,
        functools.partial(spherical_harmonics, SH), t_attr,
    )
    return je, te


def test_dense_edge_data():
    jb, tb = batches()
    bond_embed = np.random.default_rng(2).standard_normal((2, 32)).astype(np.float32)
    je, te = _edges(jb, tb, bond_embed)
    for name in ("sh_dense", "attr_dense", "adj", "sh_bond", "attr_bond", "bond_mask"):
        np.testing.assert_allclose(
            getattr(te, name).numpy(), np.asarray(getattr(je, name)), err_msg=name, **TOL
        )
    assert te.adj.sum() > 0 and te.adj.sum() < te.adj.numel()  # both kinds of pair


@pytest.mark.parametrize(
    "irreps_in,irreps_out",
    [("16x0e + 8x1e", "12x0e + 4x0e + 4x1e"), ("24x0e", "16x0e + 8x1e"), ("4x1e + 3x0e", "5x1e")],
)
def test_irreps_linear(irreps_in, irreps_out):
    from jamun_tpu_torch.ops.irreps import Irreps

    x = np.random.default_rng(3).standard_normal((2, 5, Irreps(irreps_in).dim)).astype(np.float32)
    jm = JLinear(irreps_in, irreps_out)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = load(IrrepsLinear(irreps_in, irreps_out), p)
    np.testing.assert_allclose(
        tm(t(x)).detach().numpy(), np.asarray(jm.apply(p, jnp.asarray(x))), **TOL
    )


def test_gate():
    irreps = "12x0e + 4x1e"
    jg, tg = JGate(irreps), Gate(irreps)
    x = np.random.default_rng(4).standard_normal((3, 7, tg.irreps_in.dim)).astype(np.float32)
    assert repr(tg.irreps_out) == repr(jg.irreps_out)
    np.testing.assert_allclose(tg(t(x)).numpy(), np.asarray(jg(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("S,V", [(6, 4), (5, 0)])
def test_fast_uvu_messages_dense(S, V):
    rng = np.random.default_rng(5)
    G, N = 2, 6
    x = rng.standard_normal((G, N, S + 3 * V)).astype(np.float32)
    sh = rng.standard_normal((G, N, N, 4)).astype(np.float32)
    w = rng.standard_normal((G, N, N, 2 * S + 3 * V)).astype(np.float32)
    adj = (rng.uniform(size=(G, N, N)) < 0.5).astype(np.float32)
    out, deg = fast_uvu_messages_dense(t(x), t(sh), t(w), t(adj), S, V)
    jout, jdeg = j_fast_uvu(*(jnp.asarray(a) for a in (x, sh, w, adj)), S=S, V=V)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(deg.numpy(), np.asarray(jdeg), **TOL)


@pytest.mark.parametrize("irreps_in", ["16x0e + 8x1e", "24x0e"])
def test_conv_block_plain(irreps_in):
    """The port's module-level ConvBlock against the JAX ConvBlock
    (use_pallas=False): dense pairs + bonds, mean over the combined degree,
    post-linear, gate, second linear and linear skip."""
    from jamun_tpu_torch.ops.irreps import Irreps

    irreps_out = "16x0e + 8x1e"
    jb, tb = batches()
    rng = np.random.default_rng(6)
    bond_embed = rng.standard_normal((2, 32)).astype(np.float32)
    je, te = _edges(jb, tb, bond_embed)
    x = rng.standard_normal((2, 16, Irreps(irreps_in).dim)).astype(np.float32)
    jm = JConvBlock(irreps_in, irreps_out, SH, 64, tensor_product="uvu")
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), je))
    tm = load(ConvBlock(irreps_in, irreps_out, SH, 64), p)
    want = np.asarray(jm.apply(p, jnp.asarray(x), je))
    got = tm(t(x), te).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_noise_conditioning():
    irreps = "10x0e + 3x1e"
    rng = np.random.default_rng(7)
    x1 = rng.standard_normal((2, 5, 19)).astype(np.float32)
    x2 = rng.standard_normal((2, 5, 19)).astype(np.float32)
    c = np.asarray([np.log(0.04) / 4.0], np.float32)
    js, jk = JScaling(irreps), JSkip(irreps)
    ps = perturb(js.init(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(c)))
    pk = perturb(jk.init(jax.random.PRNGKey(1), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(c)), 1)
    ts, tk = load(NoiseConditionalScaling(irreps), ps), load(NoiseConditionalSkipConnection(irreps), pk)
    np.testing.assert_allclose(
        ts(t(x1), t(c)).detach().numpy(),
        np.asarray(js.apply(ps, jnp.asarray(x1), jnp.asarray(c))), **TOL,
    )
    np.testing.assert_allclose(
        tk(t(x1), t(x2), t(c)).detach().numpy(),
        np.asarray(jk.apply(pk, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(c))), **TOL,
    )


@pytest.mark.parametrize("use_seq", [False, True])
def test_embeddings(use_seq):
    jb, tb = batches()
    dims = (8, 8, 32, 8)
    jm = JEmbed(*dims, use_residue_sequence_index=use_seq)
    p = perturb(jm.init(jax.random.PRNGKey(0), jb))
    tm = load(AtomEmbeddingWithResidueInformation(*dims, use_residue_sequence_index=use_seq), p)
    np.testing.assert_allclose(tm(tb).detach().numpy(), np.asarray(jm.apply(p, jb)), **TOL)


def test_equivariant_mlp():
    hidden = "16x0e + 8x1e"
    x = np.random.default_rng(8).standard_normal((2, 5, 40)).astype(np.float32)
    jm = JEqMLP(hidden, "1x1e", [hidden])
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = load(EquivariantMLP(hidden, "1x1e", [hidden]), p)
    np.testing.assert_allclose(
        tm(t(x)).detach().numpy(), np.asarray(jm.apply(p, jnp.asarray(x))), **TOL
    )


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|optax|jamun_tpu)(?:\.|\s|$)", re.M)


def test_port_imports_no_jax():
    """No source of the port, and not chip_smoke.py, imports jax, flax, optax
    or jamun_tpu (the pattern does not match jamun_tpu_torch), and importing
    every module of the port in a fresh interpreter loads none of them."""
    sources = sorted((REPO / "jamun_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    offenders = [str(p) for p in sources if _FORBIDDEN.search(p.read_text())]
    assert not offenders, offenders
    assert _FORBIDDEN.search("import jamun_tpu.ops\n") and not _FORBIDDEN.search(
        "import jamun_tpu_torch.ops\n"
    )
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in sorted((REPO / "jamun_tpu_torch").rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'jamun_tpu')]\n"
        "print(len(bad)); sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
