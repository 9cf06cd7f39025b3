"""The copied generators and counts: a seed gives the same inputs twice, the
operation and byte counts repeat and agree with `chip_smoke.py`'s on the
same shapes, and each traffic kind runs through its module on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.costs import e3conv as costs
from benchmark.inputs.batches import train_pool, walk_batch
from benchmark.reference.denoiser import factors, mean_center
from benchmark.tests.conftest import ROOT

WALK = dict(residues=[4], max_atoms=48, basins=["alpha", "beta", "ppii"], jitter_deg=15.0, sequences=3,
            chains_per_sequence=2, bucket=48, structure_seed=11)
HELIX = dict(residues=[31, 32, 33], max_atoms=256, basins=["alpha"], jitter_deg=3.0, sequences=2,
             chains_per_sequence=1, bucket=256, structure_seed=12)
TRAIN = {k: v for k, v in dict(WALK, batch_size=3, pool_batches=2).items() if k != "structure_seed"}


@pytest.mark.parametrize("make, params", [(walk_batch, WALK), (walk_batch, HELIX),
                                          (lambda s, p: train_pool(s, p)[1], TRAIN)])
def test_a_seed_gives_the_same_inputs(make, params):
    a, b, c = make(2**31 + 5, params), make(2**31 + 5, params), make(2**31 + 6, params)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    if "structure_seed" in params:  # the same molecules in another order: the same work
        assert sorted(a["pos"].sum((1, 2)).tolist()) == sorted(c["pos"].sum((1, 2)).tolist())
    else:
        assert not np.array_equal(a["pos"], c["pos"])
    n = a["node_mask"].sum(1)
    assert (n <= params["bucket"]).all() and (n > 0).all()
    # bonds join atoms of the molecule and come in both directions
    for g in range(len(n)):
        nb = a["bond_mask"][g].sum()
        src, dst = a["bond_src"][g, :nb], a["bond_dst"][g, :nb]
        assert src.max() < n[g] and dst.max() < n[g]
        assert set(zip(src.tolist(), dst.tolist())) == set(zip(dst.tolist(), src.tolist()))


def test_visited_pairs_count_the_pairs_inside_the_cutoff():
    b = walk_batch(9, WALK)
    got = costs.visited_pairs(torch.as_tensor(b["pos"]), torch.as_tensor(b["node_mask"]),
                              torch.as_tensor(b["bond_mask"]), 0.5)
    for g in range(len(got)):
        n = int(b["node_mask"][g].sum())
        p = b["pos"][g, :n].astype(np.float64)
        d = np.linalg.norm(p[:, None] - p[None], axis=-1)
        want = int(((d < 0.5) & ~np.eye(n, dtype=bool)).sum()) + int(b["bond_mask"][g].sum())
        assert int(got[g]) == want


def _flagship(dtype):
    from jamun_tpu_torch.models.e3conv import E3Conv

    return E3Conv(tensor_product="uvu", dtype=dtype, fused_stack=True, device="cpu", seed=3)


@pytest.mark.parametrize("dtype, cdt", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_stack_count_matches_chip_smoke(dtype, cdt):
    """K3's operations and bytes against `chip_smoke.stack_flops_bytes` on
    the same unpadded batch."""
    import chip_smoke

    model = _flagship(dtype)
    b = walk_batch(4, dict(WALK, sequences=2, chains_per_sequence=1))
    n = int(b["node_mask"].sum(1).min())
    b = {k: (v[:, :n] if v.ndim == 2 and v.shape[1] == 48 else v) for k, v in b.items()}
    b["pos"] = b["pos"][:, :n]
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    t["bond_mask"] &= (t["bond_src"] < n) & (t["bond_dst"] < n)
    from jamun_tpu_torch.ops.graph import GraphBatch

    c_in, _, _, c_noise = factors(0.04, 0.5)
    cutoff = (1.0 + 6 * 0.04**2) ** 0.5 / c_in
    scaled = GraphBatch(**t).replace_pos(t["pos"] * c_in)
    c = torch.full((1,), c_noise)
    with torch.no_grad():
        nf0 = model.NoiseConditionalScaling_0(model.AtomEmbeddingWithResidueInformation_0(scaled), c)
        args = model._stack_args(scaled, nf0, c, cutoff)
    out = torch.zeros((t["pos"].shape[0], n, 3))
    pairs = int(costs.visited_pairs(mean_center(t["pos"], t["node_mask"]) * c_in, t["node_mask"],
                                    t["bond_mask"], cutoff).sum())
    want_flops, want_bytes = chip_smoke.stack_flops_bytes(args, pairs, out)
    G, N, B = t["pos"].shape[0], n, t["bond_src"].shape[1]
    w = costs.kernel_widths(120, 32, 56)
    got = costs.stack_launch(pairs, G * N, G, N, B, w, 5, cdt)
    assert got == costs.stack_launch(pairs, G * N, G, N, B, w, 5, cdt)
    assert got == (want_flops, want_bytes)


@pytest.mark.parametrize("s_in, v_in", [(56, 0), (120, 32)])
def test_tiled_count_matches_chip_smoke(s_in, v_in):
    """K5's count as `check_fused_block_tiled` makes it: its operations, and
    its bytes from the tensors a launch reads and writes."""
    from jamun_tpu_torch.ops.cuda import conv_block as k2
    from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5

    model = _flagship(torch.bfloat16)
    blk = model.ConvBlock_0 if v_in == 0 else model._HiddenLayer_0.ConvBlock_0
    conv = blk.Conv_0
    wts = k2.pack_block_weights(conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
                                model.embed_bondedness[0], model.embed_bondedness[1], S=s_in, V=v_in,
                                cdt=torch.bfloat16)
    b = {k: torch.as_tensor(v) for k, v in walk_batch(2, HELIX).items()}
    geo = k5.tiled_geometry_inputs(b["pos"], b["node_mask"], b["bond_src"], b["bond_dst"], b["bond_mask"], 3.0, 32)
    G, N, B = b["pos"].shape[0], b["pos"].shape[1], b["bond_src"].shape[1]
    x = torch.zeros((G, N, s_in + 3 * v_in), dtype=torch.bfloat16)
    got_out = torch.zeros((G, N, wts.Sc + 3 * wts.Vg))
    want_bytes = sum(t.numel() * t.element_size() for t in (
        x, geo.pos, geo.node_mask, geo.bond_src, geo.bond_dst, geo.bond_mask, got_out, *wts.tensors()))
    pairs, Wd = 5000, 2 * s_in + 3 * v_in
    Sc, Vg = wts.Sc, wts.Vg
    want_flops = 2 * pairs * (32 * 64 + 64 * Wd) + 2 * G * N * (
        (s_in + v_in) * (Sc + Vg) + 3 * (s_in + 2 * v_in) * Vg + Sc * Sc + 3 * Vg * Vg + s_in * Sc + 3 * v_in * Vg)
    got = costs.tiled_launch(pairs, G * N, G, N, B, s_in, v_in, costs.kernel_widths(120, 32, 56), 2)
    assert got == (want_flops, want_bytes)


def test_uvw_count_takes_the_products_weights():
    """The uvw count's radial layer makes as many weights a pair as the
    port's product takes."""
    from jamun_tpu_torch.models.e3conv import E3Conv

    model = E3Conv(tensor_product="uvw", device="cpu")
    got = [sum(m1 * m3 for m1, _, _, m3, _ in costs._tp_paths(blocks, [(152, 0), (32, 1)]))
           for blocks in ([(56, 0)], [(120, 0), (32, 1)])]
    assert got == [model.ConvBlock_0.Conv_0.tp.weight_numel, model._HiddenLayer_0.ConvBlock_0.Conv_0.tp.weight_numel]
    f = costs.uvw_forward_flops(1000, 100, 120, 32, 56, 5)
    assert f == costs.uvw_forward_flops(1000, 100, 120, 32, 56, 5) and f > 2 * 1000 * 64 * 28992 * 5


@pytest.mark.parametrize("workload", ["sep_walk_4AA", "sep_walk_N256", "uvw_train_4AA"])
def test_each_traffic_kind_runs_on_the_cpu(cell_factory, workload):
    extra = dict(bucket=64, residues=[5, 6], max_atoms=60) if workload == "sep_walk_N256" else {}
    cell = cell_factory(workload, **extra)
    out = harness.run(cell, 0.2, False, lambda: 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "checks"
    assert ROOT.is_dir()
