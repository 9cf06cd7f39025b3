"""The port's CUDA kernels against their plain twins on the card, at small
shapes. CUDA kernels have no CPU mode, so these tests skip without a GPU;
`python3 chip_smoke.py` runs the same comparison at the main path's shapes.
Run on a GPU machine with
`python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`
(`tests/conftest.py` imports JAX, which that machine need not have).

Tolerance (max |kernel - plain| / max |plain|, per output or gradient
leaf): f32 1e-4 (summation order only), bf16 3e-2 (an f32 sum that differs
in its last bits can round an intermediate to the neighbouring bf16 value).
"""

import copy
import dataclasses

import pytest
import torch

from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import conv_block_bwd as k4
from jamun_tpu_torch.ops.cuda import e3_stack as k3
from jamun_tpu_torch.ops.cuda import edge_features as k1
from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5
from jamun_tpu_torch.ops.cuda import nbr_conv as k6
from jamun_tpu_torch.ops.cuda import nbr_edge_features as k7
from jamun_tpu_torch.utils.testing import make_test_batch

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_match_plain_twins(cuda, cdt):
    batch = make_test_batch(num_graphs=3, max_nodes=19, nodes_per_graph=[19, 17, 12],
                            max_bonds=40, device=cuda)
    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, dtype=cdt, device=cuda, seed=0)
    geo = (batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, 0.8, 32)
    n1, n2 = k1.KERNEL.launches, k2.KERNEL.launches
    ef, bf = k1.edge_features(*geo, cdt)
    ef_p, bf_p = k1.edge_features_plain(*geo, cdt)
    assert torch.equal(ef[..., 3], ef_p[..., 3]) and torch.equal(bf[..., 3], bf_p[..., 3])
    assert _rel(ef, ef_p) <= TOL[cdt] and _rel(bf, bf_p) <= TOL[cdt]
    gen = torch.Generator(device=cuda).manual_seed(0)
    for blk, (S, V) in ((model.ConvBlock_0, (56, 0)), (model._HiddenLayer_0.ConvBlock_0, (24, 8))):
        w = k2.pack_block_weights(
            blk.Conv_0.radial_nn, blk.Conv_0._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
            model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V, cdt=cdt,
        )
        x = torch.randn((3, 19, S + 3 * V), generator=gen, device=cuda).to(cdt)
        args = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
        assert _rel(k2.fused_conv_block(*args), k2.fused_conv_block_plain(*args)) <= TOL[cdt]
    assert (k1.KERNEL.launches - n1, k2.KERNEL.launches - n2) == (1, 2)


def _tiled_case(cuda, cdt, nodes, scale):
    """A batch, its K5 geometry, a narrow model and the (block, S, V) pairs."""
    N = max(nodes)
    batch = make_test_batch(num_graphs=len(nodes), max_nodes=N, nodes_per_graph=nodes,
                            max_bonds=2 * N, scale=scale, device=cuda)
    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, dtype=cdt, device=cuda, seed=0)
    geo = k5.tiled_geometry_inputs(batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst,
                                   batch.bond_mask, 0.8, 32)
    blocks = ((model.ConvBlock_0, 56, 0), (model._HiddenLayer_0.ConvBlock_0, 24, 8))
    return batch, model, geo, blocks


def _block_weights(model, blk, S, V, cdt):
    return k2.pack_block_weights(
        blk.Conv_0.radial_nn, blk.Conv_0._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
        model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V, cdt=cdt,
    )


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "nodes", [[136, 131, 64], [256, 200], [203, 9, 160]], ids=["N136", "N256", "N203-not-8n"]
)
def test_tiled_block_matches_plain_twin(cuda, cdt, nodes):
    """K5 against its plain twin above 128 atoms, at an N that is no multiple
    of 8 too, projector and hidden block; the degree it counted is the
    twin's on every atom (the same adjacency), and its shared memory holds
    the pair list within a block's limit."""
    batch, model, geo, blocks = _tiled_case(cuda, cdt, nodes, 0.6)
    G, N = batch.pos.shape[:2]
    gen = torch.Generator(device=cuda).manual_seed(0)
    n5 = k5.KERNEL.launches
    with torch.no_grad():
        for blk, S, V in blocks:
            w = _block_weights(model, blk, S, V, cdt)
            x = torch.randn((G, N, S + 3 * V), generator=gen, device=cuda).to(cdt)
            got, deg = k5.fused_block_tiled(x, geo, w, return_degree=True)
            want, deg_p = k5.fused_block_tiled_plain(x, geo, w, return_degree=True)
            assert torch.isfinite(got).all() and torch.equal(deg, deg_p) and deg.max() > 8
            assert _rel(got, want) <= TOL[cdt]
            smem = k5.KERNEL.fn("fused_block_tiled_smem")(int(cdt == torch.bfloat16), N, 2 * N, S, V,
                                                          w.Sc, w.Vg)
            assert 4 * (8 * N + 2 * N) < smem <= k5.MAX_SHARED_BYTES  # the pair list and more
            assert smem == k5.layout(N, 2 * N, S, V, w.Sc, w.Vg, cdt)["smem_bytes"]
    assert k5.KERNEL.launches - n5 == 2


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tiled_block_matches_conv_block_kernel(cuda, cdt):
    """K5 against K2 on K1's features at N = 112, where both run, bit for
    bit: in each dtype both builds run the same device steps (f32: the FMA
    steps of conv_block_body.cuh, 8 atoms per CTA; bf16: the tensor-core
    steps of conv_block_mma.cuh, 16 atoms per CTA) over the same pairs in
    the same order, on geometry that rounds alike."""
    batch, model, geo, blocks = _tiled_case(cuda, cdt, [112, 97, 40], 0.45)
    gen = torch.Generator(device=cuda).manual_seed(1)
    ef, bf = k1.edge_features(*geo[:7], cdt)
    with torch.no_grad():
        for blk, S, V in blocks:
            w = _block_weights(model, blk, S, V, cdt)
            x = torch.randn((3, 112, S + 3 * V), generator=gen, device=cuda).to(cdt)
            got, deg = k5.fused_block_tiled(x, geo, w, return_degree=True)
            want, _, deg2 = k2.fused_conv_block(x, ef, bf, batch.bond_src, batch.bond_dst, w,
                                                residuals=True)
            assert torch.equal(deg, deg2)
            assert torch.equal(got, want), _rel(got, want)


@pytest.mark.parametrize("kw", [{"plain": True}, {"use_pallas": False}], ids=["plain", "use_pallas"])
def test_plain_path_is_refused_on_the_card(cuda, kw):
    """The plain path is the CPU reference: asked for on the card, under
    either name, the call raises instead of running it."""
    batch = make_test_batch(num_graphs=1, max_nodes=12, max_bonds=22, device=cuda)
    model = E3Conv(tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, device=cuda, seed=0, **kw)
    with pytest.raises(ValueError, match="CPU reference path"):
        model(batch, torch.full((1,), -0.8, device=cuda), 0.8)


def test_model_above_128_atoms_takes_the_tiled_kernel(cuda):
    """On the card the model runs N > 128: K5 once per block and K1 never
    without a gradient, the plain path (no launch) with one; f32 output
    against the CPU's plain path; "auto" goes sparse (K6) where JAX does."""
    batch = make_test_batch(num_graphs=2, max_nodes=136, nodes_per_graph=[136, 131],
                            max_bonds=272, scale=0.6, device=cuda)
    arch = dict(irreps_hidden="24x0e + 8x1e", n_layers=2, seed=0, tensor_product="uvu")
    model = E3Conv(**arch, device=cuda).requires_grad_(False)
    model.output_gain.fill_(1.0)
    ref = E3Conv(**arch, device="cpu", plain=True).requires_grad_(False)
    ref.load_state_dict(model.state_dict())
    c_noise = torch.full((1,), -0.8, device=cuda)
    counts = lambda: tuple(k.KERNEL.launches for k in (k1, k2, k3, k4, k5))  # noqa: E731
    start = counts()
    out = model(batch, c_noise, 0.8)
    assert tuple(b - a for a, b in zip(start, counts())) == (0, 0, 0, 0, 3)
    assert _rel(out.cpu(), ref(batch.to("cpu"), c_noise.cpu(), 0.8)) <= 1e-4
    start = counts()
    model.requires_grad_(True)
    pos = batch.pos.clone().requires_grad_()
    model(batch.replace_pos(pos), c_noise, 0.8).square().sum().backward()
    assert counts() == start and float(pos.grad.abs().max()) > 0
    big = make_test_batch(num_graphs=1, max_nodes=512, max_bonds=1024, scale=0.8, device=cuda)
    start, n6 = counts(), k6.KERNEL.launches
    out, tel = model.requires_grad_(False)(big, c_noise, 0.8, with_telemetry=True)
    # "auto" at 512 atoms goes sparse: K6 once per block, no dense kernel
    assert counts() == start and k6.KERNEL.launches - n6 == 3 and "neighbor_overflow" in tel
    assert torch.isfinite(out).all()
    dense = E3Conv(**arch, neighbor_mode="dense", device=cuda).requires_grad_(False)
    assert torch.isfinite(dense(big, c_noise, 0.8)).all()


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sparse_kernels_match_plain_twins(cuda, cdt):
    """K7 and K6 against their plain versions on a chain at N = 203 (a
    Verlet list built within cutoff + 0.3): K7's mask and folded indices
    exactly, K6's degree exactly, the rest within the dtype's tolerance, for
    the projector and a hidden block, on the model's attributes (A = 64) and
    on K7's radial half (A = 32)."""
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists
    from jamun_tpu_torch.utils.testing import make_chain_positions

    batch = make_test_batch(num_graphs=2, max_nodes=203, nodes_per_graph=[203, 150],
                            max_bonds=406, device=cuda)
    pos = torch.from_numpy(make_chain_positions(2, 203, seed=0)).to(cuda)
    batch = batch.replace_pos(pos * batch.node_mask[..., None])
    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, dtype=cdt, device=cuda,
                   seed=0).requires_grad_(False)
    cutoff = 0.45
    idx, sup, _ = capped_neighbor_lists(batch.pos, batch.node_mask, cutoff + 0.3, 32)
    n6, n7 = k6.KERNEL.launches, k7.KERNEL.launches
    got7 = k7.nbr_edge_features(batch.pos, idx, sup, cutoff, 32, cdt)
    want7 = k7.nbr_edge_features_plain(batch.pos, idx, sup, cutoff, 32, cdt)
    assert torch.equal(got7[2], want7[2]) and torch.equal(got7[3], want7[3])
    assert _rel(got7[0], want7[0]) <= TOL[cdt] and _rel(got7[1], want7[1]) <= TOL[cdt]
    assert 0 < int(got7[2].sum()) < int(sup.sum())
    edges, _ = model._sparse_edges(batch, cutoff, (idx, sup), True)
    radial_half = dataclasses.replace(edges, sh_nbr=got7[0], attr_nbr=got7[1],
                                      nbr_mask=got7[2], nbr_idx=got7[3])
    gen = torch.Generator(device=cuda).manual_seed(0)
    for blk, (S, V) in ((model.ConvBlock_0, (56, 0)), (model._HiddenLayer_0.ConvBlock_0, (24, 8))):
        for ed in (edges, radial_half):
            x = torch.randn((2, 203, S + 3 * V), generator=gen, device=cuda).to(cdt)
            args = blk.Conv_0.nbr_kernel_args(x, ed)
            got, deg = k6.nbr_uvu_conv(*args)
            want, deg_p = k6.nbr_uvu_conv_plain(*args)
            assert torch.equal(deg, deg_p) and _rel(got, want) <= TOL[cdt]
    assert (k6.KERNEL.launches - n6, k7.KERNEL.launches - n7) == (4, 1)


def _bits(t):
    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nodes,cap", [([37, 29, 13], 32), ([300], 260)], ids=["ragged", "chunked"])
def test_edge_kernels_match_twins_and_each_other(cuda, cdt, nodes, cap):
    """K1 and K7 against their plain twins at a ragged N (tiles of whole rows
    that end inside a graph) and at N = 300 (a row of 300 pairs, 600 bonds
    and K = 260 slots, each longer than a 256-edge tile: chunks of one row):
    K1's adjacency and K7's mask and indices exactly, the rest within the
    dtype's tolerance; and K7 equal to K1 bit for bit on every kept slot's
    pair (sh[..., 1:4] against ef[..., 0:3], the radial basis against
    ef[..., 4:])."""
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists

    N = max(nodes)
    batch = make_test_batch(num_graphs=len(nodes), max_nodes=N, nodes_per_graph=nodes,
                            max_bonds=2 * N, scale=0.35 * (N / 44) ** (1 / 3), device=cuda)
    cutoff = 0.6
    geo = (batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, cutoff, 32)
    n1, n7 = k1.KERNEL.launches, k7.KERNEL.launches
    ef, bf = k1.edge_features(*geo, cdt)
    ef_p, bf_p = k1.edge_features_plain(*geo, cdt)
    assert torch.equal(ef[..., 3], ef_p[..., 3]) and torch.equal(bf[..., 3], bf_p[..., 3])
    assert _rel(ef, ef_p) <= TOL[cdt] and _rel(bf, bf_p) <= TOL[cdt]
    idx, sup, _ = capped_neighbor_lists(batch.pos, batch.node_mask, cutoff + 0.3, cap)
    got = k7.nbr_edge_features(batch.pos, idx, sup, cutoff, 32, cdt)
    want = k7.nbr_edge_features_plain(batch.pos, idx, sup, cutoff, 32, cdt)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert _rel(got[0], want[0]) <= TOL[cdt] and _rel(got[1], want[1]) <= TOL[cdt]
    kept = got[2] > 0
    g, i, _ = kept.nonzero(as_tuple=True)
    pair = ef[g, i, got[3][kept]]
    assert g.numel() > 0 and bool((pair[:, 3] == 1).all())
    assert torch.equal(_bits(got[0][kept][:, 1:4]), _bits(pair[:, 0:3]))
    assert torch.equal(_bits(got[1][kept]), _bits(pair[:, 4:]))
    assert (k1.KERNEL.launches - n1, k7.KERNEL.launches - n7) == (1, 1)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_edge_kernel_launch_shapes_match_their_mirrors(cuda, cdt):
    """The libraries' own reckoning of K1's and K7's launch shapes equals the
    Python mirrors (`layout`), whole rows and chunks of rows."""
    for G, N, B in ((3, 19, 40), (256, 44, 88), (1, 300, 600)):
        occ = k1.occupancy(G, N, B, 32, cdt)
        assert all(occ[k] == v for k, v in k1.layout(G, N, B, 32, cdt).items()), occ
    for G, N, K in ((8, 512, 32), (1, 300, 260)):
        occ = k7.occupancy(G, N, K, 32, cdt)
        assert all(occ[k] == v for k, v in k7.layout(G, N, K, 32, cdt).items()), occ


def _small(cuda, cdt):
    batch = make_test_batch(num_graphs=3, max_nodes=19, nodes_per_graph=[19, 17, 12],
                            max_bonds=40, device=cuda)
    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, dtype=cdt, device=cuda, seed=0)
    geo = (batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, 0.8, 32)
    return batch, model, k1.edge_features(*geo, cdt)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_block_bwd_matches_plain_twin(cuda, cdt):
    """K4 (and K2's residual outputs) against the plain twins, projector and
    hidden block."""
    batch, model, (ef, bf) = _small(cuda, cdt)
    gen = torch.Generator(device=cuda).manual_seed(1)
    n4 = k4.KERNEL.launches
    for blk, (S, V) in ((model.ConvBlock_0, (56, 0)), (model._HiddenLayer_0.ConvBlock_0, (24, 8))):
        conv = blk.Conv_0
        with torch.no_grad():
            w = k2.pack_block_weights(
                conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
                model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V, cdt=cdt,
            )
            x = torch.randn((3, 19, S + 3 * V), generator=gen, device=cuda).to(cdt)
            fwd = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
            out, agg, deg = k2.fused_conv_block(*fwd, residuals=True)
            agg_p, deg_p = k2.conv_block_residuals_plain(*fwd)
            assert _rel(agg, agg_p) <= TOL[cdt] and torch.equal(deg, deg_p)
            g = torch.randn(out.shape, generator=gen, device=cuda)
            args = (g, x, ef, bf, batch.bond_src, batch.bond_dst, w, agg, deg)
            got, want = k4.conv_block_bwd(*args), k4.conv_block_bwd_plain(*args)
        for name, ref in want.items():
            if ref.numel():
                assert _rel(got[name], ref) <= TOL[cdt], name
    assert k4.KERNEL.launches - n4 == 2


@pytest.mark.parametrize("A", [64, 32])
def test_sparse_messages_bf16_at_the_flagship_width(cuda, A):
    """K6's bf16 build (both radial layers on the tensor cores) at the
    flagship widths (hidden 120x0e + 32x1e, projector 56x0e) on a ragged
    chain batch (N = 203: the last CTA of 16 atoms short, a graph of 150
    atoms padded) against its twin, the degree exactly; A = 64 on the model's
    attributes, A = 32 on K7's radial half. Its launch shape is the Python
    mirror's."""
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists
    from jamun_tpu_torch.utils.testing import make_chain_positions

    cdt = torch.bfloat16
    batch = make_test_batch(num_graphs=2, max_nodes=203, nodes_per_graph=[203, 150],
                            max_bonds=406, device=cuda)
    pos = torch.from_numpy(make_chain_positions(2, 203, seed=1)).to(cuda)
    batch = batch.replace_pos(pos * batch.node_mask[..., None])
    model = E3Conv(tensor_product="uvu", dtype=cdt, device=cuda, seed=0).requires_grad_(False)
    cutoff = 0.45
    idx, sup, _ = capped_neighbor_lists(batch.pos, batch.node_mask, cutoff + 0.3, 32)
    edges, _ = model._sparse_edges(batch, cutoff, (idx, sup), True)
    if A == 32:
        sh, rad, mask, nidx = k7.nbr_edge_features(batch.pos, idx, sup, cutoff, 32, cdt)
        edges = dataclasses.replace(edges, sh_nbr=sh, attr_nbr=rad, nbr_mask=mask, nbr_idx=nidx)
    gen = torch.Generator(device=cuda).manual_seed(2)
    n6 = k6.KERNEL.launches
    for blk, (S, V) in ((model.ConvBlock_0, (56, 0)), (model._HiddenLayer_0.ConvBlock_0, (120, 32))):
        x = torch.randn((2, 203, S + 3 * V), generator=gen, device=cuda).to(cdt)
        args = blk.Conv_0.nbr_kernel_args(x, edges)
        assert args[2].shape[-1] == A
        got, deg = k6.nbr_uvu_conv(*args)
        want, deg_p = k6.nbr_uvu_conv_plain(*args)
        assert torch.equal(deg, deg_p) and _rel(got, want) <= TOL[cdt]
        occ = k6.occupancy(A, idx.shape[-1], S, V, cdt)
        assert all(occ[k] == v for k, v in k6.layout(A, idx.shape[-1], S, V, cdt).items())
        assert occ["spill_bytes"] == 0
    assert k6.KERNEL.launches - n6 == 2


def test_sparse_messages_refuse_65536_atoms_in_bf16(cuda):
    """The bf16 build packs a slot's source atom into 16 bits: from 65536
    atoms on its wrapper raises NotImplementedError, before any launch."""
    N, K, S, V, A = 1 << 16, 1, 8, 0, 64
    bf, f32 = torch.bfloat16, torch.float32
    args = (
        torch.zeros((1, N, S), dtype=bf, device=cuda), torch.zeros((1, N, K, 4), dtype=bf, device=cuda),
        torch.zeros((1, N, K, A), dtype=bf, device=cuda),
        torch.zeros((1, N, K), dtype=torch.int64, device=cuda), torch.zeros((1, N, K), device=cuda),
        torch.zeros((A, 64), dtype=bf, device=cuda), torch.zeros(64, dtype=f32, device=cuda),
        torch.zeros((64, 2 * S), dtype=bf, device=cuda), torch.zeros(2 * S, dtype=f32, device=cuda),
    )
    n6 = k6.KERNEL.launches
    with pytest.raises(NotImplementedError, match="65536"):
        k6.nbr_uvu_conv(*args, S, V)
    assert k6.KERNEL.launches == n6


def test_conv_block_bwd_bf16_at_the_flagship_width(cuda):
    """K4's bf16 build (node pass, row products and pair pass on the tensor
    cores) at the flagship widths on ragged graphs (44, 41 and 30 atoms in
    N = 48) against its twin, every gradient leaf; the pair pass's launch
    shape is the Python mirror's."""
    cdt = torch.bfloat16
    batch = make_test_batch(num_graphs=3, max_nodes=48, nodes_per_graph=[44, 41, 30],
                            max_bonds=96, device=cuda)
    model = E3Conv(tensor_product="uvu", dtype=cdt, device=cuda, seed=0).requires_grad_(False)
    geo = (batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, 0.8, 32)
    ef, bf = k1.edge_features(*geo, cdt)
    gen = torch.Generator(device=cuda).manual_seed(3)
    n4 = k4.KERNEL.launches
    for blk, (S, V) in ((model.ConvBlock_0, (56, 0)), (model._HiddenLayer_0.ConvBlock_0, (120, 32))):
        conv = blk.Conv_0
        w = k2.pack_block_weights(
            conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
            model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V, cdt=cdt,
        )
        x = torch.randn((3, 48, S + 3 * V), generator=gen, device=cuda).to(cdt)
        out, agg, deg = k2.fused_conv_block(x, ef, bf, batch.bond_src, batch.bond_dst, w, residuals=True)
        g = torch.randn(out.shape, generator=gen, device=cuda)
        args = (g, x, ef, bf, batch.bond_src, batch.bond_dst, w, agg, deg)
        got, want = k4.conv_block_bwd(*args), k4.conv_block_bwd_plain(*args)
        for name, ref in want.items():
            if ref.numel():
                assert _rel(got[name], ref) <= TOL[cdt], name
        B = batch.bond_src.shape[1]
        occ = k4.occupancy(48, B, S, V, cdt)
        assert all(occ[k] == v for k, v in k4.pair_layout(48, B, S, V, cdt).items())
        assert occ["spill_bytes"] == 0
    assert k4.KERNEL.launches - n4 == 2


def test_trainable_block_grads_match_cpu(cuda):
    """`ConvBlock.fused` under autograd on the card (K2 + K4) against the same
    block on the CPU (plain twins), f32: x and every parameter."""
    batch, model, (ef, bf) = _small(cuda, torch.float32)
    blk = model._HiddenLayer_0.ConvBlock_0
    x = torch.randn((3, 19, 48), generator=torch.Generator().manual_seed(2))
    cot = torch.randn((3, 19, 48), generator=torch.Generator().manual_seed(3))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        b = blk if dev.type == "cuda" else copy.deepcopy(blk).cpu()
        b.zero_grad(set_to_none=True)
        bond = model.embed_bondedness.detach().to(dev)
        xd = x.to(dev).requires_grad_()
        geometry = k2.PairFeatures(ef.to(dev), bf.to(dev), batch.bond_src.to(dev),
                                   batch.bond_dst.to(dev))
        out = b.fused(xd, geometry, bond[0], bond[1])
        (out * cot.to(dev)).sum().backward()
        grads.append({"x": xd.grad.cpu(), **{n: q.grad.cpu() for n, q in b.named_parameters()}})
    assert set(grads[0]) == set(grads[1]) and len(grads[0]) == 16
    for name, ref in grads[1].items():
        assert _rel(grads[0][name], ref) <= TOL[torch.float32], name


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "nodes,hidden",
    [([19, 17, 12], "24x0e + 8x1e"), ([44, 41, 44], "24x0e + 8x1e"), ([64, 60, 9], "24x0e + 8x1e"),
     ([64, 57, 64], "120x0e + 32x1e")],
    ids=["N19", "N44", "N64", "N64-flagship-width"],
)
def test_stack_kernel_matches_plain_twin_and_layerwise(cuda, cdt, nodes, hidden):
    """K3 against its plain twin, and the stack model against the layerwise
    kernel path (K1, K2, the layerwise head) on the same weights: f32 1e-4;
    bf16 5e-2 (the head rounds at other points, x is carried in f32). N = 64
    at the flagship width is the largest launch: 4 CTAs of 16 atoms."""
    N = max(nodes)
    batch = make_test_batch(num_graphs=3, max_nodes=N, nodes_per_graph=nodes, max_bonds=2 * N,
                            scale=0.35, device=cuda)
    arch = dict(irreps_hidden=hidden, n_layers=2, dtype=cdt, device=cuda, seed=0, tensor_product="uvu")
    stack, base = E3Conv(**arch, fused_stack=True), E3Conv(**arch)
    for m in (stack, base):
        m.requires_grad_(False).output_gain.fill_(1.0)
    c_noise = torch.full((1,), -0.8, device=cuda)
    nf0 = stack.NoiseConditionalScaling_0(stack.AtomEmbeddingWithResidueInformation_0(batch), c_noise)
    args = stack._stack_args(batch, nf0, c_noise, 0.8)
    n3 = k3.KERNEL.launches
    got, want = k3.e3conv_stack(*args), k3.e3conv_stack_plain(*args)
    assert got.shape == (3, N, 3) and torch.isfinite(got).all()
    assert _rel(got, want) <= TOL[cdt]
    n1, n2 = k1.KERNEL.launches, k2.KERNEL.launches
    whole = stack(batch, c_noise, 0.8)
    assert (k3.KERNEL.launches - n3, k1.KERNEL.launches - n1, k2.KERNEL.launches - n2) == (2, 0, 0)
    layerwise = base(batch, c_noise, 0.8)
    assert (k1.KERNEL.launches - n1, k2.KERNEL.launches - n2) == (1, 3)
    assert _rel(whole, layerwise) <= (1e-4 if cdt == torch.float32 else 5e-2)


def test_stack_kernel_refuses_what_it_cannot_take(cuda):
    """Outside its shapes the wrapper raises; it never takes the plain twin
    for a tensor on the card."""
    batch = make_test_batch(num_graphs=1, max_nodes=72, max_bonds=144, scale=0.5, device=cuda)
    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, device=cuda, seed=0, fused_stack=True)
    model.requires_grad_(False)
    c_noise = torch.full((1,), -0.8, device=cuda)
    nf0 = model.NoiseConditionalScaling_0(model.AtomEmbeddingWithResidueInformation_0(batch), c_noise)
    n3 = k3.KERNEL.launches
    with pytest.raises(NotImplementedError, match="outside the kernel"):
        k3.e3conv_stack(*model._stack_args(batch, nf0, c_noise, 0.8))
    assert not model._stack_ok(batch, c_noise)  # N > 64: the model takes the layerwise kernels
    assert torch.isfinite(model(batch, c_noise, 0.8)).all() and k3.KERNEL.launches == n3


@pytest.mark.parametrize("fused_stack,n_atoms,skin", [
    (True, 19, 0.0), (False, 19, 0.0), (False, 136, 0.0), (False, 512, 0.0), (False, 512, 1.0),
], ids=["stack", "layerwise", "tiled", "sparse", "sparse_cached"])
def test_walk_never_makes_the_host_wait(cuda, fused_stack, n_atoms, skin):
    """A walk step queues its kernels without waiting for the device (sync
    debug mode raises on a blocking copy or an `.item()`), on every path."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    batch = make_test_batch(num_graphs=3, max_nodes=n_atoms, max_bonds=2 * n_atoms + 2,
                            scale=0.35, device=cuda)
    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, device=cuda, seed=0,
                   fused_stack=fused_stack).requires_grad_(False)
    den = Denoiser(model, DenoiserConfig(max_radius=1.0, average_squared_distance=0.5))
    sampler = SingleMeasurementSampler(BAOAB(MCMCConfig(delta=0.04, steps=3)), 0.04,
                                       neighbor_skin=skin)
    gen = torch.Generator(device=cuda).manual_seed(0)
    sampler.walk_jump(den, batch, batch.pos, gen)  # builds, loads and caches once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sampler.walk_jump(den, batch, batch.pos, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out["xhat_traj"]).all()


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_conv_kernels_match_plain_twins(cuda, cdt):
    """K8 (V = 8 and V = 0) and K9 against their twins, the degree exactly,
    K8 and K9 bit for bit, each on its own counter; K9 refuses V = 0."""
    from jamun_tpu_torch.ops.cuda import dense_conv as k89

    batch = make_test_batch(num_graphs=3, max_nodes=19, nodes_per_graph=[19, 17, 12],
                            max_bonds=40, device=cuda)
    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, dtype=cdt, device=cuda, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    bond0 = model.embed_bondedness[0]
    n8, n9 = k89.K8.launches, k89.K9.launches
    for blk, (S, V) in ((model.ConvBlock_0, (56, 0)), (model._HiddenLayer_0.ConvBlock_0, (24, 8))):
        d0, d1 = blk.Conv_0.radial_nn.layer(0), blk.Conv_0.radial_nn.layer(1)
        x = torch.randn((3, 19, S + 3 * V), generator=gen, device=cuda).to(cdt)
        args = (batch.pos, batch.node_mask, x, d0.kernel, d0.bias, d1.kernel, d1.bias, bond0, 0.8, S, V)
        out, deg = k89.packed_uvu_conv_dense(*args)
        want, deg_p = k89.packed_uvu_conv_dense_plain(*args)
        assert torch.equal(deg, deg_p) and _rel(out, want) <= TOL[cdt]
        if V:
            out9, deg9 = k89.fused_uvu_conv_dense(*args)
            assert torch.equal(out9, out) and torch.equal(deg9, deg)
        else:
            with pytest.raises(ValueError):
                k89.fused_uvu_conv_dense(*args)
    assert (k89.K8.launches - n8, k89.K9.launches - n9) == (2, 1)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["K5", "K8/K9"])
def test_tiled_kernels_in_passes_match_plain_twins(cuda, cdt, kernel):
    """K5 (N = 1200) and the K8/K9 kernel (N = 1500) at the flagship hidden
    width, where the bf16 build lists the pairs in passes over the sources
    (`layout`: two passes each), against their twins: the degree exactly,
    K9 equal to K8 bit for bit; the library's launch shape is the mirror's."""
    from jamun_tpu_torch.ops.cuda import dense_conv as k89

    nodes = [1200, 1111] if kernel == "K5" else [1500, 1400]
    N = max(nodes)
    batch = make_test_batch(num_graphs=2, max_nodes=N, nodes_per_graph=nodes, max_bonds=2 * N,
                            scale=0.35 * (N / 44) ** (1 / 3), device=cuda)
    model = E3Conv(tensor_product="uvu", dtype=cdt, device=cuda, seed=0)
    blk, S, V = model._HiddenLayer_0.ConvBlock_0, 120, 32
    x = torch.randn((2, N, S + 3 * V), generator=torch.Generator(device=cuda).manual_seed(8),
                    device=cuda).to(cdt)
    with torch.no_grad():
        if kernel == "K5":
            geo = k5.tiled_geometry_inputs(batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst,
                                           batch.bond_mask, 0.8, 32)
            w = _block_weights(model, blk, S, V, cdt)
            got, deg = k5.fused_block_tiled(x, geo, w, return_degree=True)
            want, deg_p = k5.fused_block_tiled_plain(x, geo, w, return_degree=True)
            occ, mirror = k5.occupancy(N, 2 * N, S, V, w.Sc, w.Vg, cdt), k5.layout(N, 2 * N, S, V, w.Sc, w.Vg, cdt)
        else:
            d0, d1 = blk.Conv_0.radial_nn.layer(0), blk.Conv_0.radial_nn.layer(1)
            args = (batch.pos, batch.node_mask, x, d0.kernel, d0.bias, d1.kernel, d1.bias,
                    model.embed_bondedness[0], 0.8, S, V)
            got, deg = k89.packed_uvu_conv_dense(*args)
            want, deg_p = k89.packed_uvu_conv_dense_plain(*args)
            got9, deg9 = k89.fused_uvu_conv_dense(*args)
            assert torch.equal(got9, got) and torch.equal(deg9, deg)
            occ, mirror = k89.occupancy(N, S, V, cdt), k89.layout(N, S, V, cdt)
    assert torch.isfinite(got).all() and torch.equal(deg, deg_p) and deg.max() > 8
    assert _rel(got, want) <= TOL[cdt]
    assert {k: occ[k] for k in mirror} == mirror
    assert mirror["sources_per_pass"] < N if cdt == torch.bfloat16 else mirror["sources_per_pass"] == N


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_layer_mode_matches_plain_twin(cuda, cdt):
    """K2's layer mode (`conv_layer`) against its twin for a mixed l <= 1
    irreps_out, on its own counter; K2's whole-block counter is untouched."""
    from jamun_tpu_torch.ops.conv import Conv

    batch = make_test_batch(num_graphs=3, max_nodes=19, nodes_per_graph=[19, 17, 12],
                            max_bonds=40, device=cuda)
    geo = (batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, 0.8, 32)
    ef, bf = k1.edge_features(*geo, cdt)
    gen = torch.Generator().manual_seed(4)
    conv = Conv("24x0e + 8x1e", "6x0e + 3x1e + 10x0e + 4x1e", "1x0e + 1x1e", 64).to(cuda)
    for prm in conv.parameters():
        prm.data.copy_(torch.randn(prm.shape, generator=gen))
    bond = torch.randn(2, 32, generator=gen).to(cuda)
    w = k2.layer_weights(conv.radial_nn, conv._post_linear, bond[0], bond[1], S=24, V=8, cdt=cdt)
    x = torch.randn((3, 19, 48), generator=gen).to(cuda, cdt)
    n2, nl = k2.KERNEL.launches, k2.LAYER_KERNEL.launches
    got = k2.conv_layer(x, ef, bf, batch.bond_src, batch.bond_dst, w)
    want = k2.conv_layer_plain(x, ef, bf, batch.bond_src, batch.bond_dst, w)
    assert got.shape == (3, 19, 6 + 9 + 10 + 12) and _rel(got, want) <= TOL[cdt]
    assert (k2.KERNEL.launches - n2, k2.LAYER_KERNEL.launches - nl) == (0, 1)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tensor_core_paths_at_ragged_sizes(cuda, cdt):
    """K2 (block and layer mode) and K3 at ragged N (41 and 19 atoms) with a
    narrow width whose V, S + V and 2S + 3V are no multiple of 16 or 8
    (24x0e + 5x1e: W = 63, padded to 64), so the bf16 tiles' padding is
    exercised; each against its plain twin; the shared memory each launch
    takes equals the Python mirror of the library's reckoning."""
    from jamun_tpu_torch.ops.conv import Conv

    for nodes in ([41, 37, 41], [19, 12, 19]):
        N = max(nodes)
        batch = make_test_batch(num_graphs=3, max_nodes=N, nodes_per_graph=nodes, max_bonds=2 * N,
                                scale=0.35, device=cuda)
        model = E3Conv(
            tensor_product="uvu", irreps_hidden="24x0e + 5x1e", n_layers=2, dtype=cdt, device=cuda, seed=0)
        model.requires_grad_(False).output_gain.fill_(1.0)
        geo = (batch.pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, 0.8, 32)
        ef, bf = k1.edge_features(*geo, cdt)
        gen = torch.Generator(device=cuda).manual_seed(5)
        for blk, (S, V) in ((model.ConvBlock_0, (56, 0)), (model._HiddenLayer_0.ConvBlock_0, (24, 5))):
            w = _block_weights(model, blk, S, V, cdt)
            x = torch.randn((3, N, S + 3 * V), generator=gen, device=cuda).to(cdt)
            args = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
            assert _rel(k2.fused_conv_block(*args), k2.fused_conv_block_plain(*args)) <= TOL[cdt]
            occ = k2.occupancy(N, 2 * N, S, V, w.Sc, w.Vg, cdt)
            assert occ["smem_bytes"] == k2.smem_bytes(N, 2 * N, S, V, w.Sc, w.Vg, cdt)
        conv = Conv("24x0e + 5x1e", "7x0e + 3x1e + 2x0e", "1x0e + 1x1e", 64).to(cuda)
        cpu_gen = torch.Generator().manual_seed(6)
        for prm in conv.parameters():  # a bare Conv's parameters are not initialised
            prm.data.copy_(torch.randn(prm.shape, generator=cpu_gen))
        lw = k2.layer_weights(conv.radial_nn, conv._post_linear, model.embed_bondedness[0],
                              model.embed_bondedness[1], S=24, V=5, cdt=cdt)
        x = torch.randn((3, N, 39), generator=gen, device=cuda).to(cdt)
        largs = (x, ef, bf, batch.bond_src, batch.bond_dst, lw)
        assert _rel(k2.conv_layer(*largs), k2.conv_layer_plain(*largs)) <= TOL[cdt]
        occ = k2.occupancy(N, 2 * N, 24, 5, lw.C0, lw.V1, cdt, layer=True)
        assert occ["smem_bytes"] == k2.smem_bytes(N, 2 * N, 24, 5, lw.C0, lw.V1, cdt, layer=True)
        stack = E3Conv(
            tensor_product="uvu", irreps_hidden="24x0e + 5x1e", n_layers=2, dtype=cdt, device=cuda, seed=0,
                       fused_stack=True)
        stack.requires_grad_(False).output_gain.fill_(1.0)
        c_noise = torch.full((1,), -0.8, device=cuda)
        nf0 = stack.NoiseConditionalScaling_0(stack.AtomEmbeddingWithResidueInformation_0(batch), c_noise)
        sargs = stack._stack_args(batch, nf0, c_noise, 0.8)
        got, want = k3.e3conv_stack(*sargs), k3.e3conv_stack_plain(*sargs)
        assert torch.isfinite(got).all() and _rel(got, want) <= TOL[cdt]
        shape = k3.launch_shape(N, 2 * N, 24, 5, 56, compute_dtype=cdt)
        mirror = k3.stack_shape(N, 2 * N, 24, 5, 56, compute_dtype=cdt)
        assert {k: shape[k] for k in mirror} == mirror


def test_kabsch_kernel_matches_svd(cuda):
    """The SVD-free rotation against `kabsch_align`'s SVD path on the CPU, G
    = 32, N = 48: random rotations, mirrored inputs, near-planar graphs and
    single-atom graphs; aligned positions 1e-5 of the max (the single-atom
    graphs align to their centroid either way). No host wait."""
    from jamun_tpu_torch.ops.cuda import kabsch as kb
    from jamun_tpu_torch.ops.geometry import kabsch_align

    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 48, 3, generator=g)
    q, _ = torch.linalg.qr(torch.randn(32, 3, 3, generator=g))
    q = q * torch.sign(torch.linalg.det(q))[:, None, None]
    y = torch.einsum("gnj,gij->gni", x, q) + 0.05 * torch.randn(32, 48, 3, generator=g)
    y[8:16] = y[8:16] * torch.tensor([1.0, 1.0, -1.0])
    x[16:24, :, 2] *= 1e-3
    mask = torch.ones(32, 48, dtype=torch.bool)
    mask[24:, 1:] = False
    mask[:8, 40:] = False
    x, y = x * mask[..., None], y * mask[..., None]
    want = kabsch_align(y, x, mask)
    n = kb.KERNEL.launches
    yc, xc, mc = y.to(cuda), x.to(cuda), mask.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kabsch_align(yc, xc, mc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kb.KERNEL.launches - n == 1
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


def test_aligned_training_step_never_waits(cuda, tmp_path):
    """One `Trainer.fit` step with `align_noisy_input_during_training` (the
    default) under sync debug mode: the alignment takes the Kabsch kernel,
    and nothing in the step waits for the device."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.ops.cuda import kabsch as kb
    from jamun_tpu_torch.train.distributions import ConstantSigma
    from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
    from jamun_tpu_torch.train.optim import adam
    from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger

    model = E3Conv(
        tensor_product="uvu", irreps_hidden="24x0e + 8x1e", n_layers=1, dtype=torch.bfloat16, device=cuda, seed=0)
    den = Denoiser(model, DenoiserConfig(max_radius=1.0, average_squared_distance=0.3,
                                         mirror_augmentation_rate=0.5, add_fixed_noise=True))
    assert den.config.align_noisy_input_during_training
    host = make_test_batch(num_graphs=4, max_nodes=19, max_bonds=40, device="cpu")
    cfg = TrainerConfig(max_steps=1, log_every_n_steps=1000, seed=0,
                        checkpoint_dir=str(tmp_path / "ckpt"))

    def fit():
        return Trainer(cfg, RecordingLogger(), device=cuda).fit(
            den, adam(2.0e-3), ConstantSigma(0.04), FixedBatches([host])
        )

    fit()  # the cached constants
    n = kb.KERNEL.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = fit()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 1 and kb.KERNEL.launches - n == 1


@pytest.mark.parametrize("n_atoms", [136, 40], ids=["recompute", "k4"])
def test_trainable_tiled_block_matches_cpu(cuda, n_atoms):
    """K5 under autograd (`ConvBlock.fused` on a `TiledGeometry` with a
    gradient wanted): one K5 launch forward; the backward recomputes the
    plain twin above 128 atoms, or runs K1, K2 and K4 at or below. Output
    and every gradient (x and each parameter), f32, against the same block
    on the CPU (the twins throughout)."""
    from jamun_tpu_torch.ops.conv import ConvBlock

    batch = make_test_batch(num_graphs=2, max_nodes=n_atoms, max_bonds=2 * n_atoms, scale=0.6,
                            device="cpu")
    gen = torch.Generator().manual_seed(3)
    base = ConvBlock("16x0e + 8x1e", "16x0e + 8x1e", "1x0e + 1x1e", 64)
    for m in base.modules():
        if m is not base and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.randn((2, n_atoms, 40), generator=gen)
    bond = torch.randn((2, 32), generator=gen)
    cot = torch.randn((2, n_atoms, 40), generator=gen)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        m = copy.deepcopy(base).to(dev)
        b = batch.to(dev)
        geo = k5.tiled_geometry_inputs(b.pos, b.node_mask, b.bond_src, b.bond_dst, b.bond_mask, 0.9)
        xt = x.clone().to(dev).requires_grad_(True)  # a leaf of its own on each device
        n5 = k5.KERNEL.launches
        out = m.fused(xt, geo, bond[0].to(dev), bond[1].to(dev))
        assert k5.KERNEL.launches - n5 == (1 if dev.type == "cuda" else 0)
        (out * cot.to(dev)).sum().backward()
        outs.append([out.detach().cpu(), xt.grad.cpu()] + [p.grad.cpu() for p in m.parameters()])
    for got, want in zip(outs[1], outs[0]):
        assert _rel(got, want) <= TOL[torch.float32]


OPTAX_RULES = {
    "sgd_nesterov": ("sgd", dict(learning_rate=5e-2, momentum=0.9, nesterov=True)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=1e-2, centered=True, momentum=0.8)),
    "adamax": ("adamax", dict(learning_rate=1e-2)),
    "nadam": ("nadam", dict(learning_rate=1e-2)),
    "nadamw_mask": ("nadamw", dict(learning_rate=1e-2, weight_decay=0.1,
                                   mask={"w": True, "b": False})),
    "adam_mu_bf16": ("adam", dict(learning_rate=1e-2, mu_dtype="bfloat16")),
    "lion": ("lion", dict(learning_rate=1e-3)),
    "adam_warmup_cosine": ("adam", dict(learning_rate="warmup_cosine")),
    # the rules built from optax's scale_by_* steps (noisy_sgd's draws differ by device)
    "adabelief": ("adabelief", dict(learning_rate=1e-2)),
    "adadelta": ("adadelta", dict(learning_rate=1.0)),
    "adafactor_factored": ("adafactor", dict(learning_rate=1e-2, min_dim_size_to_factor=2,
                                             momentum=0.9)),
    "adamaxw": ("adamaxw", dict(learning_rate=1e-2)),
    "adan": ("adan", dict(learning_rate=1e-2)),
    "amsgrad": ("amsgrad", dict(learning_rate=1e-2)),
    "fromage": ("fromage", dict(learning_rate=1e-2)),
    "lamb": ("lamb", dict(learning_rate=1e-2, weight_decay=1e-2)),
    "lars": ("lars", dict(learning_rate=1.0, weight_decay=1e-2)),
    "novograd": ("novograd", dict(learning_rate=1e-2)),
    "optimistic_adam_v2": ("optimistic_adam_v2", dict(learning_rate=1e-2)),
    "optimistic_gradient_descent": ("optimistic_gradient_descent", dict(learning_rate=1e-2)),
    "radam": ("radam", dict(learning_rate=1e-2)),
    "rprop": ("rprop", dict(learning_rate=1e-2)),
    "sign_sgd": ("sign_sgd", dict(learning_rate=1e-2)),
    "sm3": ("sm3", dict(learning_rate=1e-2)),
    "yogi": ("yogi", dict(learning_rate=1e-2)),
}


@pytest.mark.parametrize("case", sorted(OPTAX_RULES))
def test_optax_rules_on_the_card_match_the_cpu(cuda, case):
    """Each rule of `train/optim.py` added with the rest of optax, ten steps
    on the card against the same rule on the CPU on the same gradients
    (1e-5 of each parameter's largest entry: the card's sqrt and rsqrt may
    round otherwise)."""
    from jamun_tpu_torch.train import optim

    rule, kwargs = OPTAX_RULES[case]
    if kwargs["learning_rate"] == "warmup_cosine":
        kwargs = dict(kwargs, learning_rate=optim.warmup_cosine_decay_schedule(0.0, 2e-2, 3, 10))
    gen = torch.Generator().manual_seed(0)
    init = {"w": torch.randn(6, 5, generator=gen), "b": torch.randn(5, generator=gen)}
    grads = [{k: torch.randn(v.shape, generator=gen) for k, v in init.items()} for _ in range(10)]
    sides = {}
    for dev in ("cpu", cuda):
        params = {k: torch.nn.Parameter(v.clone().to(dev)) for k, v in init.items()}
        opt = getattr(optim, rule)(**kwargs)(list(params.items()))
        for g in grads:
            for k, p in params.items():
                p.grad = g[k].to(dev)
            opt.step()
        sides[str(dev)] = {k: p.detach().cpu() for k, p in params.items()}
    for k in init:
        assert _rel(sides[str(cuda)][k], sides["cpu"][k]) <= 1e-5, k
        assert not torch.equal(sides["cpu"][k], init[k])


def test_atom_sharded_forward_on_two_gloo_ranks_of_one_card(cuda, tmp_path):
    """`atom_sharded_arch_apply` on two gloo ranks of the one card (CUDA
    tensors; gloo sums each rank's rows into a zero tensor for the gathers)
    against the single-process forward on the card (the kernel path; the
    sharded forward runs the plain one), f32, 1e-4."""
    from jamun_tpu_torch.parallel import launch

    kw = dict(tensor_product="uvu", irreps_hidden="16x0e + 8x1e", n_layers=2)
    model = E3Conv(**kw, device=cuda, seed=0)
    model.output_gain.data.fill_(1.0)
    model.requires_grad_(False)
    batch = make_test_batch(num_graphs=2, max_nodes=24, nodes_per_graph=[21, 24], max_bonds=48,
                            device=cuda)
    c_noise = -0.8
    want = model(batch, torch.tensor([c_noise], device=cuda), 1.2)
    spec = dict(arch=kw, state={k: v.cpu() for k, v in model.state_dict().items()},
                batch=launch.batch_spec(batch), c_noise=c_noise, cutoff=1.2, device="cuda:0")
    for r in launch.spawn(launch.forward_worker, 2, (spec,), backend="gloo", workdir=str(tmp_path),
                          timeout=300):
        assert _rel(r["out"], want.cpu()) <= TOL[torch.float32]
