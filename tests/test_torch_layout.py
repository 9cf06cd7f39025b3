"""The Python mirrors of the kernels' shared-memory reckoning and launch
shapes (`ops/cuda/conv_block.smem_bytes`, `ops/cuda/e3_stack.stack_shape`,
`ops/cuda/fused_block_tiled.layout`, `ops/cuda/dense_conv.layout`), on the
CPU. On the card `tests/test_torch_cuda.py` and `chip_smoke.py` hold them to
the libraries' own query functions (`conv_block_occupancy`,
`e3_stack_shape`, `fused_block_tiled_occupancy`, `dense_conv_occupancy`);
here they are held to what the kernels must be able to launch: every shape
the wrappers accept fits the 227 KB a block may use, and the flagship shapes
take the launch shapes the design notes give.
"""

import pytest
import torch

from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import dense_conv as k89
from jamun_tpu_torch.ops.cuda import e3_stack as k3
from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5

WIDTHS = [(120, 32), (56, 0), (24, 5), (24, 8), (1, 1), (120, 40), (192, 0)]  # W <= 384


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layer", [False, True], ids=["block", "layer"])
def test_conv_block_fits_every_accepted_shape(cdt, layer):
    """K2 takes N <= 128 (the edge features' regime) and 2S + 3V <= 384: each
    such CTA fits, bonds at two per atom."""
    for S, V in WIDTHS:
        assert 2 * S + 3 * V <= k2.MAX_WIDTH
        for N in (1, 8, 19, 44, 64, 112, 128):
            Sc, Vg = (S + V, V) if layer else (S, max(V, 1))
            assert k2.smem_bytes(N, 2 * N, S, V, Sc, Vg, cdt, layer) <= k2.MAX_SMEM, (S, V, N)


def test_conv_block_bf16_layout_at_the_flagship():
    """The bf16 CTA (16 dst atoms) at the 4AA hidden block, item by item
    (conv_block.cu `mma_layout`): what lives through the CTA, then one region
    for the pair loop's tiles and staged source rows or, after them, the
    epilogue's tiles and its staged B operands (n-major, [round_up(N, 8)]
    [ld(K)]: the second step's lin20, sk0, lin21 and sk1 are the larger)."""
    N, B, S, V = 44, 88, 120, 32
    nt, W, F, nl = 352, 336, 216, 16 * 44 + 88
    persistent = 16 * 3 * nt * 4 + 64 + 32 * 16 + 64 + (nl + 1) * 4 + 12 + nl * 4
    tiles = 64 * 40 * 2 + 336 * 64 * 2 + 32 * 40 * 2 + 32 * 72 * 2 + 16 * 344 * 2
    post = (152 * 168 + 32 * 200) * 2  # pl0 [152][152], pl1 [184][32]
    second = (2 * 120 * 136 + 2 * 32 * 40) * 2  # lin20, sk0 [120][120]; lin21, sk1 [32][32]
    assert k2.threads_for(W) == nt
    assert k2.pair_tiles_bytes(W) == tiles
    assert k2.staged_b_bytes(S, V, S + V, V, S, V) == max(post, second) == second
    epi = k2.epilogue_tiles_bytes(S, V, S + V, V, S, V, 16)
    assert k2.epilogue_tiles_bytes(S, V, S + V, V, S, V, 16, stage=True) == epi + second
    assert epi < tiles + 32 * F * 2 < epi + second
    assert k2.smem_bytes(N, B, S, V, S, V) == persistent + epi + second == 201808


def test_conv_block_stages_b_only_at_equal_occupancy():
    """The epilogue stages its B operands where the CTA still fits and as
    many CTAs share an SM (228 KB, 1 KB reserved per CTA): at 4AA the hidden
    block (one CTA per SM either way: 154576 or 201808 bytes) stages them,
    the projector (three CTAs per SM at 67920 bytes, one at 120400) reads
    them from device memory."""
    def ctas(nbytes):
        return 233472 // (nbytes + 1024)

    assert k2.stage_fits(201808, 154576) and ctas(201808) == ctas(154576) == 1
    assert k2.smem_bytes(44, 88, 120, 32, 120, 32) == 201808
    assert not k2.stage_fits(120400, 67920) and ctas(67920) == 3
    assert k2.smem_bytes(44, 88, 56, 0, 120, 32) == 67920
    assert not k2.stage_fits(k2.MAX_SMEM + 16, 154576)


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_stack_shape_fits_every_accepted_size(cdt):
    """K3 at the flagship width for every N <= 64: a cluster of at most 8
    CTAs of at most 16 atoms each, inside a block's shared memory."""
    for N in range(1, k3.MAX_ATOMS + 1):
        sh = k3.stack_shape(N, 2 * N, 120, 32, 56, compute_dtype=cdt)
        assert sh["ctas_per_cluster"] * sh["atoms_per_cta"] >= N
        assert sh["ctas_per_cluster"] <= 8 and sh["atoms_per_cta"] <= 16, (N, sh)
        assert sh["smem_bytes"] <= k2.MAX_SMEM, (N, sh)


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_stack_shape_at_the_walk_sizes(cdt):
    """4AA runs as 4 CTAs of 11 atoms, 2AA as 2 of 10, N = 64 as 4 of 16;
    8 atoms per CTA when asked."""
    shape = lambda N, a=0: k3.stack_shape(N, 2 * N, 120, 32, 56, a, compute_dtype=cdt)  # noqa: E731
    assert (shape(44)["ctas_per_cluster"], shape(44)["atoms_per_cta"]) == (4, 11)
    assert (shape(19)["ctas_per_cluster"], shape(19)["atoms_per_cta"]) == (2, 10)
    assert (shape(64)["ctas_per_cluster"], shape(64)["atoms_per_cta"]) == (4, 16)
    assert (shape(44, 8)["ctas_per_cluster"], shape(44, 8)["atoms_per_cta"]) == (6, 8)


# ---- K5 and the K8/K9 kernel (`fused_block_tiled.layout`, `dense_conv.layout`) ----

FLAGSHIP = [("hidden", 120, 32), ("projector", 56, 0)]  # the blocks' (S, V); gate 120x0e + 32x1e


def _fma_max_atoms(smem) -> int:
    """The largest N whose FMA-build CTA fits a block (smem(N) grows with N)."""
    n = 1
    while smem(n + 1) <= k2.MAX_SMEM:
        n += 1
    return n


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_tiled_kernels_fit_every_accepted_shape(cdt):
    """What the wrappers accept (the reckoned bytes within 227 KB) is a CTA
    whose parts fit: for the bf16 builds, the pair loop's region with a pass
    list of 16 J + B entries and, for K5, the epilogue's region; J is every
    source or a multiple of 32, never below 32."""
    for S, V in WIDTHS:
        for N in (1, 8, 19, 44, 112, 129, 203, 256, 512, 1024, 2000, 3000):
            for B in (N, 2 * N):
                k5l = k5.layout(N, B, S, V, S, max(V, 1), cdt)
                k89l = k89.layout(N, S, V, cdt)
                for lay in (k5l, k89l):
                    J = lay["sources_per_pass"]
                    assert J == N or (J % 32 == 0 and 32 <= J < N), (S, V, N, lay)
                    assert lay["threads"] == k2.threads_for(2 * S + 3 * V)
                if cdt == torch.bfloat16 and k5l["smem_bytes"] <= k2.MAX_SMEM:
                    J, nt = k5l["sources_per_pass"], k5l["threads"]
                    persistent = 16 * 3 * nt * 4 + 64 + 64 + 16  # acc, degree, counts, length
                    pair = (N * 16 + 32 * 16 + k2.pair_tiles_bytes(2 * S + 3 * V)
                            + k2._align16(32 * (S + 3 * V) * 2) + (16 * J + B) * 4)
                    epi = k2.epilogue_tiles_bytes(S, V, S + max(V, 1), max(V, 1), S, max(V, 1), 16,
                                                  k5l["staged"])
                    assert persistent + max(pair, epi) <= k5l["smem_bytes"] <= k2.MAX_SMEM


@pytest.mark.parametrize("block,S,V", FLAGSHIP, ids=[b for b, _, _ in FLAGSHIP])
@pytest.mark.parametrize("bonds", [1, 2], ids=["B=N", "B=2N"])
def test_tiled_block_range_no_narrower_than_fma(block, S, V, bonds):
    """K5's bf16 build accepts every N that its FMA build accepts at the
    flagship width (2902 atoms with two bonds per atom, 3125 with one, for
    the hidden block), by walking the sources in passes."""
    fma = _fma_max_atoms(lambda n: k5.layout(n, bonds * n, S, V, 120, 32, torch.float32)["smem_bytes"])
    assert fma == {("hidden", 1): 3125, ("hidden", 2): 2902, ("projector", 1): 3539,
                   ("projector", 2): 3286}[block, bonds]
    for N in range(1, fma + 1):
        assert k5.layout(N, bonds * N, S, V, 120, 32)["smem_bytes"] <= k2.MAX_SMEM, N


@pytest.mark.parametrize("block,S,V", FLAGSHIP, ids=[b for b, _, _ in FLAGSHIP])
def test_dense_messages_range_no_narrower_than_fma(block, S, V):
    """The K8/K9 kernel's bf16 build accepts every N that its FMA build
    accepts at the flagship width (3695 atoms for the hidden block, the
    bound of ROADMAP item A9) and more."""
    fma = _fma_max_atoms(lambda n: k89.layout(n, S, V, torch.float32)["smem_bytes"])
    assert fma == {"hidden": 3695, "projector": 4143}[block]
    for N in range(1, fma + 1):
        assert k89.layout(N, S, V)["smem_bytes"] <= k2.MAX_SMEM, N
    assert k89.layout(5127, 120, 32)["smem_bytes"] <= k2.MAX_SMEM < k89.layout(5128, 120, 32)["smem_bytes"]


def test_tiled_layouts_at_the_walk_shapes():
    """The bf16 CTAs at the walks' shapes (flagship width, two bonds per
    atom): 16 dst atoms, every source in one pass, K5's epilogue staging its
    B operands; the hidden block's CTA takes one SM (the accumulators of 16
    atoms x 3 x 352 channels and the tiles), the projector's two. Above
    about 950 atoms K5's hidden block walks its sources in passes; the dense
    messages at 3695 atoms in passes of 384."""
    hidden = k5.layout(256, 512, 120, 32, 120, 32)
    assert hidden == dict(threads=352, smem_bytes=194960, atoms_per_cta=16, sources_per_pass=256,
                          staged=True)
    persistent = 16 * 3 * 352 * 4 + 64 + 64 + 16  # acc, degree, counts, the list's length
    assert hidden["smem_bytes"] == persistent + k2.epilogue_tiles_bytes(120, 32, 152, 32, 120, 32, 16, True)
    assert 233472 // (hidden["smem_bytes"] + 1024) == 1
    projector = k5.layout(256, 512, 56, 0, 120, 32)
    assert projector["staged"] and projector["sources_per_pass"] == 256
    assert 233472 // (projector["smem_bytes"] + 1024) == 2
    assert k5.layout(512, 1024, 120, 32, 120, 32)["sources_per_pass"] == 512
    assert k5.layout(955, 1910, 120, 32, 120, 32)["sources_per_pass"] == 955
    assert k5.layout(1200, 2400, 120, 32, 120, 32)["sources_per_pass"] == 832
    assert k5.layout(112, 224, 120, 32, 120, 32)["sources_per_pass"] == 112  # K2's list, one pass
    four_aa = k89.layout(44, 120, 32)
    assert four_aa == dict(threads=352, smem_bytes=151888, atoms_per_cta=16, sources_per_pass=44,
                           staged=False)
    assert k89.layout(256, 120, 32)["sources_per_pass"] == 256
    assert k89.layout(1500, 120, 32)["sources_per_pass"] == 928
    assert k89.layout(3695, 120, 32)["sources_per_pass"] == 384
    assert k89.layout(44, 120, 32, torch.float32)["atoms_per_cta"] == 8
