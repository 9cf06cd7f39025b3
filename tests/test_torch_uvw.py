"""The port's fully connected (uvw) product against JAX (CPU, f32): the real
Clebsch-Gordan tensors, `WeightedTensorProduct`, `E3Conv(tensor_product=
"uvw")` forward and gradients on the dense and the sparse path, E(3)
equivariance, and the denoiser's training loss. Then the messages on the
live pairs (`Conv._tp_messages` on `ops/graph.live_pairs`) against the dense
masked sum they replaced, kept here as the reference, for the uvw and the
experimental product on every layout, the pair counter, and the separable
model, which never compacts. Then the grouped uvw product (one batched
product per output group) against the per-path product it replaced, kept
here as the reference (`_per_path_tp`), its call counter, and the autograd
graph it builds at the published widths.

JAX runs uvw through XLA einsums (no Pallas kernel reaches it), and so does
the port through PyTorch's. Parameters: JAX `init`, every leaf perturbed with
seeded numpy noise so that no gradient is trivially 0. Each tolerance is
written beside its check.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.cg import real_wigner_3j as j_real_wigner_3j
from jamun_tpu.ops.tensor_product import fully_connected_tp as j_fully_connected_tp
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
import jamun_tpu_torch.ops.graph as graph_mod
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.attention import split_irreps
from jamun_tpu_torch.ops.cg import real_wigner_3j
from jamun_tpu_torch.ops.conv import Conv
from jamun_tpu_torch.ops.graph import PAIR_COUNTS
from jamun_tpu_torch.ops.neighbors import gather_neighbors
from jamun_tpu_torch.ops.sh import spherical_harmonics
from jamun_tpu_torch.ops.tensor_product import (
    PRODUCT_CALLS, WeightedTensorProduct, depthwise_tp, fully_connected_tp,
)
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvw")


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path[1:]): np.asarray(v) for path, v in flat}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )


@pytest.mark.parametrize("ls", [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0), (1, 1, 1), (1, 1, 2), (2, 1, 1),
                                (2, 2, 2), (1, 2, 3)])
def test_real_wigner_3j_equals_jax(ls):
    """The numpy computation is the same code: equal bits."""
    np.testing.assert_array_equal(real_wigner_3j(*ls), j_real_wigner_3j(*ls))


@pytest.mark.parametrize("irreps", [
    ("16x0e + 8x1e", "1x0e + 1x1e", "24x0e + 8x0e + 8x1e"),
    ("12x0e", "1x0e + 1x1e", "20x0e + 4x0e + 4x1e"),
    ("3x0e + 2x1e + 1x2e", "1x0e + 1x1e + 1x2e", "2x0e + 3x1e + 2x2e + 1x1o"),
])
def test_weighted_tensor_product_matches_jax(irreps):
    """Paths, path weights and the product itself, per-element weights,
    within 1e-5 of the output's max (f32 summation order)."""
    tp, jtp = fully_connected_tp(*irreps), j_fully_connected_tp(*irreps)
    assert tp.weight_numel == jtp.weight_numel
    assert [(i.i_in1, i.i_in2, i.i_out, i.path_weight, i.weight_offset, i.weight_shape)
            for i in tp.instructions] == [
        (i.i_in1, i.i_in2, i.i_out, i.path_weight, i.weight_offset, i.weight_shape)
        for i in jtp.instructions]
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((5, 7, tp.irreps_in1.dim)).astype(np.float32)
    x2 = rng.standard_normal((5, 7, tp.irreps_in2.dim)).astype(np.float32)
    w = rng.standard_normal((5, 7, tp.weight_numel)).astype(np.float32)
    got = tp(*map(torch.from_numpy, (x1, x2, w))).numpy()
    want = np.asarray(jtp(*map(jnp.asarray, (x1, x2, w))))
    assert got.shape == want.shape == (5, 7, tp.irreps_out.dim)
    assert _rel(got, want) < 1e-5


def _model_setup(neighbor_mode: str, seed: int = 0, n_atoms: int = 12):
    kw = dict(num_graphs=2, max_nodes=n_atoms, nodes_per_graph=[n_atoms, n_atoms - 2],
              max_bonds=2 * n_atoms, scale=0.35, seed=seed)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    nbr = dict(neighbor_mode=neighbor_mode, neighbor_cap=6)
    jm = JE3Conv(**ARCH, **nbr)
    c_noise = np.asarray([np.log(SIGMA) / 4.0], np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), jb, jnp.asarray(c_noise), 0.9), 10 + seed)
    tm = E3Conv(**ARCH, **nbr, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, jb, tm, tb, c_noise


@pytest.mark.parametrize("neighbor_mode", ["dense", "nbr"])
def test_e3conv_uvw_matches_jax(neighbor_mode):
    """E3Conv(tensor_product="uvw") at 16x0e + 8x1e, 2 layers, N = 12 with a
    padded graph: the f32 output within 1e-4 of its max, and the gradients of
    a random projection of the output within 1e-4 of each leaf's max (sums
    over every pair of the batch). "nbr": capped lists of 6 neighbours (some
    rows drop in-cutoff edges), JAX's generic sparse path."""
    jm, params, jb, tm, tb, c_noise = _model_setup(neighbor_mode)
    assert not tm.kernels  # uvw has no kernel route
    proj = np.random.default_rng(7).standard_normal((2, 12, 3)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, jb, jnp.asarray(c_noise), 0.9, training=True) * proj)

    jout = np.asarray(jm.apply(params, jb, jnp.asarray(c_noise), 0.9))
    jgrads = _flat(jax.grad(jloss)(params))
    out = tm(tb, torch.from_numpy(c_noise), 0.9)
    assert _rel(out.detach().numpy(), jout) < 1e-4
    assert np.abs(jout).max() > 1e-2
    (out * torch.from_numpy(proj)).sum().backward()
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in tm.named_parameters()}
    assert set(got) == set(jgrads)
    # uvw blocks have no post-linear: the radial MLP makes every path's weight
    assert not any("_post_linear" in n for n in got)
    live = [n for n, g in jgrads.items() if np.abs(g).max() > 0]
    assert len(live) >= len(jgrads) - 2, sorted(set(jgrads) - set(live))
    for name, ref in jgrads.items():
        if name in live:
            assert _rel(got[name], ref) < 1e-4, (name, _rel(got[name], ref))
        else:  # an embedding table the batch does not index
            assert np.abs(got[name]).max() == 0, name


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


@pytest.mark.parametrize("neighbor_mode", ["dense", "nbr"])
def test_uvw_score_equivariance(neighbor_mode):
    """score(R y + t) = R score(y) - t / sigma^2 for the uvw denoiser: 1e-4
    of the score's max (f32)."""
    _, _, _, tm, tb, _ = _model_setup(neighbor_mode, seed=2)
    den = Denoiser(tm, DenoiserConfig(1.0, 0.3))
    R = torch.from_numpy(_rotation(3).astype(np.float32))
    shift = torch.tensor([0.3, -0.2, 0.5])
    mask = tb.node_mask[..., None].float()
    with torch.no_grad():
        s = den.score(tb, SIGMA)
        s_rot = den.score(tb.replace_pos((tb.pos @ R.T + shift) * mask), SIGMA)
    err = (s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()
    assert float(err) < 1e-4


def test_uvw_training_loss_matches_jax():
    """The denoiser's training loss (alignment on, noise of ones on both
    sides): loss and metrics within 1e-5 relative."""
    kw = dict(num_graphs=2, max_nodes=12, nodes_per_graph=[12, 10], max_bonds=24, scale=0.35, seed=4)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    jden = JDenoiser(JE3Conv(**ARCH), JConfig(1.0, 0.3, add_fixed_ones=True))
    params = _perturbed(jden.init(jax.random.PRNGKey(4), jb), 14)
    arch = E3Conv(**ARCH, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    den = Denoiser(arch, DenoiserConfig(1.0, 0.3, add_fixed_ones=True))
    jloss, jaux = jden.training_loss(params, jax.random.PRNGKey(0), jb, SIGMA)
    loss, aux = den.training_loss(tb, SIGMA, torch.Generator())
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in ("coordinate_loss", "raw_coordinate_loss", "scaled_rmsd", "loss"):
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k


# ---- the messages on the live pairs against the dense masked sum ----


def _per_path_tp(tp, x1, x2, weights):
    """The reference product of `tp`'s instructions, path by path, as the
    port computed every product before its uvw paths were grouped: per path
    the CG contraction (x2 with C first), the weights' einsum, the path
    weight and a sum into the output block. weights [..., weight_numel] or
    [weight_numel] (shared)."""
    batch_shape = x1.shape[:-1]
    sl1, sl2 = tp.irreps_in1.slices(), tp.irreps_in2.slices()
    out_blocks = [None] * len(tp.irreps_out)
    for ins in tp.instructions:
        mi1, mi2, mi3 = tp.irreps_in1[ins.i_in1], tp.irreps_in2[ins.i_in2], tp.irreps_out[ins.i_out]
        f1 = x1[..., sl1[ins.i_in1]].reshape(batch_shape + (mi1.mul, mi1.ir.dim))
        f2 = x2[..., sl2[ins.i_in2]].reshape(batch_shape + (mi2.mul, mi2.ir.dim))
        cg = real_wigner_3j(mi1.ir.l, mi2.ir.l, mi3.ir.l) * math.sqrt(mi3.ir.dim)
        C = torch.as_tensor(cg, dtype=x1.dtype, device=x1.device)
        w = weights[..., ins.weight_offset:ins.weight_offset + int(np.prod(ins.weight_shape))]
        w = w.reshape(w.shape[:-1] + ins.weight_shape)
        t = torch.einsum("...ui,...vik->...uvk", f1, torch.einsum("...vj,ijk->...vik", f2, C))
        if ins.mode == "uvw":
            blk = torch.einsum("...uvk,...uvw->...wk", t, w)
        else:
            blk = torch.einsum("...uvk,...uv->...uk", t, w)
        blk = ins.path_weight * blk
        i3 = ins.i_out
        out_blocks[i3] = blk if out_blocks[i3] is None else out_blocks[i3] + blk
    flat = [
        x1.new_zeros(batch_shape + (mi3.dim,)) if blk is None else blk.reshape(batch_shape + (mi3.dim,))
        for mi3, blk in zip(tp.irreps_out, out_blocks)
    ]
    return torch.cat(flat, dim=-1)


def _dense_tp_messages(conv, src, edges, out_dtype):
    """The reference: a message on every slot of the dense [G, N, N_src]
    or capped [G, N, K] layout, then the sum masked by the adjacency (JAX's
    generic paths, `jamun_tpu/ops/conv.py:253-262, 353-364`). The uvw
    messages come from the per-path reference on the radial MLP's whole
    output, independent of the grouped product."""
    cdt = src.dtype

    def product(x1, x2, attr):
        if conv.tensor_product == "uvw":
            return _per_path_tp(conv.tp, x1, x2, conv.radial_nn(attr.to(cdt)))
        return conv.tp(x1, x2, conv._path_weights(attr.to(cdt)))

    if edges.nbr_idx is None:
        G, N_src, D = src.shape
        N = edges.adj.shape[1]
        msg = product(src[:, None].expand(G, N, N_src, D), edges.sh_dense.to(cdt), edges.attr_dense)
        out = torch.einsum("gijd,gij->gid", msg.to(out_dtype), edges.adj.to(out_dtype))
        return out, edges.adj.sum(-1)
    msg = product(gather_neighbors(src, edges.nbr_idx), edges.sh_nbr.to(cdt), edges.attr_nbr)
    out = torch.einsum("gnkd,gnk->gnd", msg.to(out_dtype), edges.nbr_mask.to(out_dtype))
    return out, edges.nbr_mask.sum(-1)


# batch: (atoms per graph, N, graph moved out of every other's cutoff,
# cutoff, neighbour cap); "all_live": every pair of the real atoms inside
# the cutoff, and with the cap at N - 1 every capped slot live
_BATCHES = {
    "padded": ([12, 9], 12, None, 0.9, 6),
    "empty_graph": ([12, 10], 12, 1, 0.9, 6),
    "all_live": ([10, 10], 10, None, 100.0, 9),
}


def _compact_case(product, layout, batch, seed=0):
    nodes, N, far, cutoff, cap = _BATCHES[batch]
    tb = make_test_batch(num_graphs=len(nodes), max_nodes=N, nodes_per_graph=nodes, max_bonds=2 * N,
                         scale=0.35, seed=seed, device="cpu")
    if far is not None:  # its atoms 50 cutoffs apart: no radial pair, bonds kept
        pos = tb.pos.clone()
        pos[far] *= 50 * cutoff / 0.35
        tb = tb.replace_pos(pos)
    model = E3Conv(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product=product,
                   neighbor_mode=layout, neighbor_cap=cap, device="cpu", seed=seed)
    with torch.no_grad():
        model.output_gain.fill_(1.0)
        for p in model.parameters():  # no gradient trivially 0
            p.add_(0.3 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 5)))
    return model, tb, cutoff


def _forward_and_grads(model, run):
    """The output of `run()` and every parameter's gradient of a random
    projection of it (zeros where none flows)."""
    model.zero_grad(set_to_none=True)
    out = run()
    proj = torch.randn(out.shape, generator=torch.Generator().manual_seed(11))
    (out * proj).sum().backward()
    return out.detach(), {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                          for n, p in model.named_parameters()}


def _compact_and_dense(monkeypatch, model, run):
    """(compact, dense) sides of `_forward_and_grads`, and the live pairs
    the compact side counted."""
    live0 = PAIR_COUNTS.live
    got = _forward_and_grads(model, run)
    live = PAIR_COUNTS.live - live0
    with monkeypatch.context() as m:
        m.setattr(Conv, "_tp_messages", _dense_tp_messages)
        want = _forward_and_grads(model, run)
    return got, want, live


def _assert_close(got, want, tol=1e-5):
    (out, grads), (out_ref, grads_ref) = got, want
    assert np.abs(out_ref.numpy()).max() > 1e-3
    assert _rel(out.numpy(), out_ref.numpy()) <= tol
    live = [n for n, g in grads_ref.items() if g.abs().max() > 0]
    assert len(live) >= len(grads_ref) - 2, sorted(set(grads_ref) - set(live))
    for name, ref in grads_ref.items():
        if name in live:
            assert _rel(grads[name].numpy(), ref.numpy()) <= tol, (name, _rel(grads[name], ref))
        else:  # an embedding row the batch does not index
            assert grads[name].abs().max() == 0, name


@pytest.mark.parametrize("batch", list(_BATCHES))
@pytest.mark.parametrize("layout", ["dense", "nbr"])
@pytest.mark.parametrize("product", ["uvw", "experimental"])
def test_compact_messages_match_the_dense_masked_sum(monkeypatch, product, layout, batch):
    """E3Conv's forward and every parameter gradient on the live pairs
    against the dense masked sum, f32, within 1e-5 of each one's max (the
    order of the sums); the live pairs are those the adjacency counts."""
    model, tb, cutoff = _compact_case(product, layout, batch)
    c_noise = torch.tensor([np.log(SIGMA) / 4.0])
    got, want, live = _compact_and_dense(monkeypatch, model, lambda: model(tb, c_noise, cutoff))
    _assert_close(got, want)
    with torch.no_grad():
        if layout == "dense":
            adj = model._plain_edges(tb, cutoff).adj
        else:
            adj = model._sparse_edges(tb, cutoff, None, False)[0].nbr_mask
    assert live == int(adj.sum())
    if batch == "empty_graph":
        assert adj[1].sum() == 0 and adj[0].sum() > 0
    if batch == "all_live":
        G, N = tb.node_mask.shape
        assert int(adj.sum()) == (G * N * (N - 1) if layout == "dense" else adj.numel())


@pytest.mark.parametrize("product", ["uvw", "experimental"])
def test_compact_messages_in_the_sharded_layout(monkeypatch, product):
    """The atom-sharded layout in one process (`E3Conv.sharded_forward`
    with no group), and a `Conv` on a rank's 5 of 12 destination rows
    ([G, 5, 12] adjacency, sources the whole gathered molecule): forward and
    gradients against the dense masked sum, 1e-5."""
    model, tb, cutoff = _compact_case(product, "dense", "padded")
    c_noise = torch.tensor([np.log(SIGMA) / 4.0])
    got, want, _ = _compact_and_dense(
        monkeypatch, model, lambda: model.sharded_forward(tb, c_noise, cutoff, None)[0])
    _assert_close(got, want)

    conv = model._HiddenLayer_0.ConvBlock_0.Conv_0
    rows = torch.arange(4, 9)
    G = tb.pos.shape[0]
    edges = graph_mod.dense_edge_data(
        tb.pos[:, rows], tb.node_mask[:, rows], tb.bond_src[:, :0], tb.bond_dst[:, :0],
        tb.bond_mask[:, :0], cutoff, functools.partial(spherical_harmonics, model.irreps_sh),
        model._attr_fn(cutoff),
        src_pos=tb.pos, src_mask=tb.node_mask, dst_index=rows.expand(G, -1),
    )
    assert edges.adj.shape == (G, 5, 12) and 0 < edges.adj.sum() < edges.adj.numel()
    x = torch.randn((G, 12, conv.irreps_in.dim), generator=torch.Generator().manual_seed(3))
    sides = []
    for fn in (Conv._tp_messages, _dense_tp_messages):
        xs = x.clone().requires_grad_(True)
        conv.zero_grad(set_to_none=True)
        out, deg = fn(conv, xs, edges, torch.float32)
        (out * torch.randn(out.shape, generator=torch.Generator().manual_seed(4))).sum().backward()
        sides.append((out.detach(), deg, xs.grad, [p.grad.clone() for p in conv.parameters()]))
    (out, deg, gx, gp), (out_r, deg_r, gx_r, gp_r) = sides
    assert torch.equal(deg, deg_r)
    assert _rel(out.numpy(), out_r.numpy()) <= 1e-5 and _rel(gx.numpy(), gx_r.numpy()) <= 1e-5
    for g, r in zip(gp, gp_r):
        assert _rel(g.numpy(), r.numpy()) <= 1e-5


def test_no_live_pair_gives_zero_messages_and_gradients():
    """P = 0 (every pair outside the cutoff): zero messages and degree, and
    zero gradients of the radial MLP and the source features."""
    model, tb, _ = _compact_case("uvw", "dense", "padded")
    conv = model._HiddenLayer_0.ConvBlock_0.Conv_0
    edges = model._plain_edges(tb, 1e-4)
    pairs = graph_mod.edge_pairs(edges)
    assert pairs.count == 0 and pairs.attr.shape == (0, edges.attr_dense.shape[-1])
    x = torch.randn((2, 12, conv.irreps_in.dim), requires_grad=True)
    conv.zero_grad(set_to_none=True)
    out, deg = conv._tp_messages(x, dataclasses.replace(edges, pairs=pairs), torch.float32)
    assert out.shape == (2, 12, conv.tp.irreps_out.dim) and torch.equal(out, torch.zeros_like(out))
    assert deg.abs().max() == 0
    (out * 1.5).sum().backward()
    assert x.grad is None or x.grad.abs().max() == 0
    for p in conv.radial_nn.parameters():
        assert p.grad is not None and p.grad.abs().max() == 0


@pytest.mark.parametrize("layout", ["dense", "nbr"])
def test_pair_counter_reads_one_list_a_forward(layout):
    """After one uvw forward the counter has grown by the adjacency's sum
    (live pairs) and by the layout's slot count once: the six `Conv` calls
    share one list."""
    model, tb, cutoff = _compact_case("uvw", layout, "padded")
    with torch.no_grad():
        if layout == "dense":
            mask = model._plain_edges(tb, cutoff).adj
        else:
            mask = model._sparse_edges(tb, cutoff, None, False)[0].nbr_mask
        live0, slots0 = PAIR_COUNTS.live, PAIR_COUNTS.slots
        model(tb, torch.tensor([-0.8]), cutoff)
    assert PAIR_COUNTS.live - live0 == int(mask.sum())
    assert PAIR_COUNTS.slots - slots0 == mask.numel()
    assert mask.numel() == (2 * 12 * 12 if layout == "dense" else 2 * 12 * 6)


@pytest.mark.parametrize("kw", [
    dict(tensor_product="uvu"),
    dict(tensor_product="uvu", plain=True),
    dict(tensor_product="uvu", neighbor_mode="nbr"),
    dict(tensor_product="uvu", fused_stack=True),
], ids=["layerwise", "plain", "nbr", "stack"])
def test_separable_forward_never_compacts_pairs(monkeypatch, kw):
    """A spy on `live_pairs`: the separable model's forwards (its kernel
    twins, its plain path, the sparse path, the whole-model stack) never
    call it, so the walks never wait there; a uvw forward calls it once."""
    calls = []
    real = graph_mod.live_pairs
    monkeypatch.setattr(graph_mod, "live_pairs", lambda *a, **k: calls.append(1) or real(*a, **k))
    tb = make_test_batch(num_graphs=2, max_nodes=12, max_bonds=24, scale=0.35, device="cpu")
    c_noise = torch.tensor([-0.8])
    sep = E3Conv(irreps_hidden="16x0e + 8x1e", n_layers=2, neighbor_cap=6, device="cpu", seed=0, **kw)
    assert not sep.pair_lists
    with torch.no_grad():
        sep(tb, c_noise, 0.9)
    sep(tb, c_noise, 0.9).sum().backward()
    assert calls == []
    uvw = E3Conv(**ARCH, device="cpu", seed=0)
    assert uvw.pair_lists
    uvw(tb, c_noise, 0.9).sum().backward()
    assert calls == [1]


# ---- the grouped uvw product against the per-path reference ----

_Q_HEAD = str(split_irreps("16x0e + 8x1e", 2)[1])
# (x1, x2, out irreps, instructions): the flagship Conv's (its first layer
# too), those of `test_weighted_tensor_product_matches_jax`, the l = 2 uvw
# E3Conv's hidden Conv, attention's q.k `dot`, and uvw and uvu paths mixed
_PRODUCTS = {
    "flagship": ("120x0e + 32x1e", "1x0e + 1x1e", "120x0e + 32x0e + 32x1e", None),
    "flagship_first": ("56x0e", "1x0e + 1x1e", "120x0e + 32x0e + 32x1e", None),
    "jax_sv": ("16x0e + 8x1e", "1x0e + 1x1e", "24x0e + 8x0e + 8x1e", None),
    "jax_scalars": ("12x0e", "1x0e + 1x1e", "20x0e + 4x0e + 4x1e", None),
    "jax_l2": ("3x0e + 2x1e + 1x2e", "1x0e + 1x1e + 1x2e", "2x0e + 3x1e + 2x2e + 1x1o", None),
    "uvw_l2": ("8x0e + 4x1e + 2x2e", "1x0e + 1x1e + 1x2e", "8x0e + 4x0e + 2x0e + 4x1e + 2x2e", None),
    "attention_dot": (_Q_HEAD, _Q_HEAD, "1x0e", None),
    "mixed": ("4x0e + 2x1e", "1x0e + 1x1e", "4x0e + 4x1e + 2x0e + 3x1e",
              [(0, 0, 0, "uvw"), (1, 1, 0, "uvw"), (0, 1, 1, "uvu"), (1, 0, 1, "uvw"), (1, 1, 2, "uvw")]),
}


def _product(name):
    x1, x2, out, instructions = _PRODUCTS[name]
    return WeightedTensorProduct(x1, x2, out, instructions)


@pytest.mark.parametrize("weights", ["flat", "shared", "per_group"])
@pytest.mark.parametrize("name", list(_PRODUCTS))
def test_grouped_product_matches_the_per_path_reference(name, weights):
    """The product's output and the gradients of x1, x2 and the weights
    against `_per_path_tp`, f32, within 1e-5 of each one's max (the order
    of the sums within a group, the path weight folded into C). Weights per
    element on a [3, 5] batch, shared on a [3, 5] batch, or per element on a
    [7] batch as the list `weight_groups` describes (the radial MLP's)."""
    tp = _product(name)
    batch = (7,) if weights == "per_group" else (3, 5)
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    x1 = torch.randn(batch + (tp.irreps_in1.dim,), generator=gen)
    x2 = torch.randn(batch + (tp.irreps_in2.dim,), generator=gen)
    w = torch.randn(((tp.weight_numel,) if weights == "shared" else batch + (tp.weight_numel,)), generator=gen)
    proj = torch.randn(batch + (tp.irreps_out.dim,), generator=gen)
    sides = []
    for side in ("grouped", "reference"):
        leaves = [t.clone().requires_grad_(True) for t in (x1, x2, w)]
        a, b, wl = leaves
        if side == "reference":
            out = _per_path_tp(tp, a, b, wl)
        elif weights == "per_group":
            out = tp(a, b, [wl[..., c] if isinstance(c, slice) else wl.index_select(-1, c)
                            for c in tp.weight_groups(wl.device)])
        else:
            out = tp(a, b, wl)
        (out * proj).sum().backward()
        sides.append([out.detach()] + [t.grad for t in leaves])
    assert sides[0][0].shape == batch + (tp.irreps_out.dim,)
    for got, want, what in zip(*sides, ("out", "x1", "x2", "weights")):
        assert want.abs().max() > 1e-3, what
        assert _rel(got.numpy(), want.numpy()) <= 1e-5, (what, _rel(got.numpy(), want.numpy()))


def test_product_groups_the_uvw_paths_by_output_block():
    """The flagship Conv's seven paths make two groups: `120x0e + 32x0e`
    (w 152) from 0e x 0e and 1e x 1e (U = 120 + 32), and `32x1e` from
    0e x 1e, 1e x 0e and 1e x 1e (U = 120 + 32 + 32, k = 3); each group's
    weight index holds every weight of its paths once."""
    tp = _product("flagship")
    assert [(g.outs, g.w, g.U, g.k) for g in tp._groups] == [((0, 1), 152, 152, 1), ((2,), 32, 184, 3)]
    assert not tp._paths
    cols = np.concatenate([g.columns.reshape(-1) for g in tp._groups])
    assert np.array_equal(np.sort(cols), np.arange(tp.weight_numel))


def test_product_calls_count_grouped_and_per_path():
    """`PRODUCT_CALLS`: a uvw product counts one grouped call, the uvu
    (depthwise) one a per-path call, a product with both one of each; the
    uvw E3Conv's forward only grouped calls (two a Conv: pairs and bonds),
    the generic uvu of l = 2 only per-path ones, and the fast uvu shape
    none (its messages never reach the product)."""

    def delta(run):
        before = dict(PRODUCT_CALLS)
        run()
        return {k: PRODUCT_CALLS[k] - before[k] for k in before}

    def call(tp):
        return lambda: tp(torch.randn(4, tp.irreps_in1.dim), torch.randn(4, tp.irreps_in2.dim),
                          torch.randn(4, tp.weight_numel))

    assert delta(call(_product("flagship"))) == {"grouped": 1, "per_path": 0}
    assert delta(call(depthwise_tp("16x0e + 8x1e", "1x0e + 1x1e", "16x0e + 8x1e")[0])) == {
        "grouped": 0, "per_path": 1}
    assert delta(call(_product("mixed"))) == {"grouped": 1, "per_path": 1}

    tb = make_test_batch(num_graphs=2, max_nodes=12, max_bonds=24, scale=0.35, device="cpu")
    c_noise = torch.tensor([-0.8])
    l2 = dict(irreps_sh="1x0e + 1x1e + 1x2e", irreps_hidden="8x0e + 4x1e + 2x2e", n_layers=2)
    for kw, want in [
        (dict(ARCH), {"grouped": 6, "per_path": 0}),
        (dict(tensor_product="uvu", **l2), {"grouped": 0, "per_path": 6}),
        (dict(tensor_product="uvu", irreps_hidden="16x0e + 8x1e", n_layers=2), {"grouped": 0, "per_path": 0}),
    ]:
        model = E3Conv(**kw, device="cpu", seed=0)
        with torch.no_grad():
            assert delta(lambda: model(tb, c_noise, 0.9)) == want, kw


def _graph(root, stop=()):
    """The autograd nodes reachable from `root`, not walking past `stop`."""
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return seen


def test_uvw_training_loss_builds_a_small_autograd_graph(monkeypatch):
    """The flagship uvw denoiser (published widths, 5 layers) at G = 4:
    one `training_loss` builds at most 1900 autograd nodes (3302 with the
    per-path product), and each of its 12 product calls at most 40 (68-172
    before): the host walks this graph at every training step."""
    calls = []
    real = WeightedTensorProduct.__call__

    def spy(self, x1, x2, weights):
        out = real(self, x1, x2, weights)
        ins = [x1, x2] + ([weights] if torch.is_tensor(weights) else list(weights))
        calls.append((out.grad_fn, {t.grad_fn for t in ins if t.grad_fn is not None}))
        return out

    monkeypatch.setattr(WeightedTensorProduct, "__call__", spy)
    tb = make_test_batch(num_graphs=4, max_nodes=48, max_bonds=96, scale=0.35, device="cpu")
    den = Denoiser(E3Conv(device="cpu", seed=0), DenoiserConfig(1.0, 0.5))
    assert den.arch.tensor_product == "uvw" and str(den.arch.irreps_hidden) == "120x0e + 32x1e"
    loss, _ = den.training_loss(tb, SIGMA, torch.Generator().manual_seed(0))
    inside = [len(_graph(out, stop)) for out, stop in calls]
    assert len(calls) == 12 and max(inside) <= 40, inside
    assert len(_graph(loss.grad_fn)) <= 1900
