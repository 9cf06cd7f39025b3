"""The Python mirrors of the kernels' shared-memory reckoning and launch
shapes (`ops/cuda/conv_block.smem_bytes`, `ops/cuda/e3_stack.stack_shape`,
`ops/cuda/fused_block_tiled.layout`, `ops/cuda/dense_conv.layout`,
`ops/cuda/nbr_conv.layout`, `ops/cuda/conv_block_bwd.pair_layout` and
`node_layout`, `ops/cuda/edge_features.layout`,
`ops/cuda/nbr_edge_features.layout`), on the CPU. On the card
`tests/test_torch_cuda.py` and `chip_smoke.py` hold them to the libraries'
own query functions (`conv_block_occupancy`, `e3_stack_shape`,
`fused_block_tiled_occupancy`, `dense_conv_occupancy`, `nbr_conv_occupancy`,
`conv_block_bwd_occupancy`, `edge_features_occupancy`,
`nbr_edge_features_occupancy`);
here they are held to what the kernels must be able to launch: every shape
the wrappers accept fits the 227 KB a block may use, and the flagship shapes
take the launch shapes the design notes give.
"""

import pytest
import torch

from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import conv_block_bwd as k4
from jamun_tpu_torch.ops.cuda import dense_conv as k89
from jamun_tpu_torch.ops.cuda import e3_stack as k3
from jamun_tpu_torch.ops.cuda import edge_features as k1
from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5
from jamun_tpu_torch.ops.cuda import nbr_conv as k6
from jamun_tpu_torch.ops.cuda import nbr_edge_features as k7

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


# ---- K6 and K4 (`nbr_conv.layout`, `conv_block_bwd.pair_layout`, `node_layout`) ----

def _ctas_per_sm(nbytes: int) -> int:
    """CTAs whose shared memory fits one SM (228 KB, 1 KB reserved per CTA)."""
    return 233472 // (nbytes + 1024)


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("A", [32, 64])
def test_nbr_conv_fits_every_accepted_shape(cdt, A):
    """K6 takes A = 32 or 64 attributes, K <= 256 slots and 2S + 3V <= 384:
    each such CTA (8 dst atoms in bf16, 16 in f32) fits a block's shared
    memory, with one thread per radial channel."""
    for S, V in WIDTHS:
        for K in (1, 8, 31, 32, 100, k6.MAX_SLOTS):
            lay = k6.layout(A, K, S, V, cdt)
            assert lay["threads"] == k2.threads_for(2 * S + 3 * V)
            assert lay["atoms_per_cta"] == (8 if cdt == torch.bfloat16 else 16)
            assert lay["smem_bytes"] <= k2.MAX_SMEM, (S, V, K, lay)


def test_nbr_conv_bf16_layout_at_the_walk_shape():
    """The bf16 CTA at the sparse walk's hidden block (A = 64, K = 32 slots),
    item by item (`nbr_conv.cu` `mma_layout`): the accumulators, degree and
    list length of 8 atoms, a tile's pair data, the operand tiles with a
    layer 1 64 wide (w2 among them, out of the registers), the list of 8 K
    slots and their sources; the source rows are read from device memory.
    Two CTAs share an SM (108848 B), the projector's four; A = 32 takes
    6144 B less (w1 and the tile's attributes)."""
    nt, W = 352, 336
    persistent = 8 * 3 * nt * 4 + 32 + 16
    tiles = 64 * 72 * 2 + W * 64 * 2 + 32 * 72 * 2 + 32 * 72 * 2 + 16 * 344 * 2
    assert k2.pair_tiles_bytes(W, 64) == tiles
    assert k2.pair_tiles_bytes(W, 32) == tiles - 6144  # w1t and the tile's A operand, 40 wide
    total = persistent + 32 * 16 + tiles + 2 * 8 * 32 * 4
    assert total == 108848
    assert k6.layout(64, 32, 120, 32) == dict(threads=nt, smem_bytes=total, atoms_per_cta=8)
    assert k6.layout(32, 32, 120, 32)["smem_bytes"] == total - 6144
    assert _ctas_per_sm(total) == 2
    projector = k6.layout(64, 32, 56, 0)
    assert projector["threads"] == 128 and _ctas_per_sm(projector["smem_bytes"]) == 4
    assert k2.pair_tiles_bytes(W) == k2.pair_tiles_bytes(W, 32)  # the dense kernels' A = 32


def test_nbr_conv_ctas_at_the_walk_shapes():
    """8 dst atoms per CTA (bf16): the N = 512, G = 8 chain launches 512
    CTAs (under two waves of 264 at two per SM), N = 1024, G = 2 launches
    256, the ragged N = 203, G = 3 batch 78."""
    td = k6.layout(64, 32, 120, 32)["atoms_per_cta"]
    for N, G, ctas in ((512, 8, 512), (1024, 2, 256), (203, 3, 78)):
        assert G * -(-N // td) == ctas


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_conv_block_bwd_fits_every_accepted_shape(cdt):
    """K4 runs where K2 does (N <= 128, bonds at up to two per atom): its pair
    pass (a list of 16 N + B entries in bf16, 8 N + B in f32) and its node
    pass fit a block's shared memory at every accepted width."""
    for S, V in WIDTHS:
        for N in (1, 8, 19, 44, 48, 64, 112, 128):
            for B in (N, 2 * N):
                lay = k4.pair_layout(N, B, S, V, cdt)
                assert lay["threads"] == k2.threads_for(2 * S + 3 * V)
                assert lay["smem_bytes"] <= k2.MAX_SMEM, (S, V, N, B, lay)
            Sc, Vg = S, max(V, 1)
            assert k4.node_layout(S, V, Sc, Vg, cdt)["smem_bytes"] <= k2.MAX_SMEM


def test_conv_block_bwd_layouts_at_the_training_shape():
    """The bf16 pair pass at the training shape (hidden block, N = 48 with
    two bonds per atom), item by item (`conv_block_bwd.cu` `pair_layout`):
    w1 and w2 n-major, a tile of 32 pairs' operands (radial features both
    ways with the bias rows, h both ways, h32, w, d_w_all both ways, d_h32),
    16 source rows and their dx sums, the dW1 sums, the pair data and the
    list. 16 sources per CTA: 96 CTAs at G = 32, one wave at one per SM (the
    FMA build: 8 sources, 192 CTAs, 1.45 waves). The node pass: 16 atoms,
    71680 B."""
    N, B, W, F = 48, 96, 336, 216
    parts = [64 * 40 * 2, W * 64 * 2, 32 * 40 * 2, 48 * 40 * 2, 32 * 72 * 2, 64 * 40 * 2, 32 * 64 * 4,
             32 * 344 * 2, 32 * 344 * 2, W * 40 * 2, 64 * 40 * 2, 16 * F * 2, 16 * F * 4, 34 * 64 * 4,
             32 * 24, 80, (16 * N + B) * 4]
    bf16 = k4.pair_layout(N, B, 120, 32)
    assert bf16 == dict(threads=352, smem_bytes=sum(parts), sources_per_cta=16)
    assert sum(parts) == 182224 and _ctas_per_sm(sum(parts)) == 1
    assert 32 * -(-N // bf16["sources_per_cta"]) == 96 <= 132
    f32 = k4.pair_layout(N, B, 120, 32, torch.float32)
    assert f32["sources_per_cta"] == 8 and 32 * -(-N // 8) == 192
    node = k4.node_layout(120, 32, 120, 32)
    assert node == dict(smem_bytes=71680, atoms_per_cta=16)
    projector = k4.pair_layout(N, B, 56, 0)
    assert projector["threads"] == 128 and _ctas_per_sm(projector["smem_bytes"]) == 2


def test_conv_block_bwd_row_product_scratch():
    """The bf16 row products keep one 32 x 32 partial per output tile and
    chunk of 256 (row, component) pairs; at the training shape (1536 rows,
    hidden block) that is 486 tiles, inside the pair pass's block partials
    that share the scratch (96 x (34 x 64 + 65 x 336) floats)."""
    M, S, V, Sc, Vg = 32 * 48, 120, 32, 120, 32
    tiles = (25 + 16 + 16) * 6 + (6 + 1 + 1) * 18
    assert k4._row_product_partials(M, S, V, Sc, Vg) == tiles * 1024 == 497664
    assert tiles * 1024 < 96 * (34 * 64 + 65 * 336)
    assert k4._row_product_partials(1, S, V, Sc, Vg) == 65 * 1024  # one chunk per tile


# ---- K1 and K7 (`edge_features.layout`, `nbr_edge_features.layout`) ----

def _tile_runs(G: int, n_rows: int, length: int, channels: int, edges: int) -> list:
    """(first element, elements) of each CTA's run in a [G, n_rows, length,
    channels] output, tiled as the kernels' `tiling` and `tile_at` do."""
    rows, cols, chunks, per_graph = k1.tiling(n_rows, length, edges)
    runs = []
    for g in range(G):
        for t in range(per_graph):
            if chunks == 1:
                i0, j0, n = t * rows, 0, min(rows, n_rows - t * rows) * length
            else:
                i0, j0 = divmod(t, chunks)
                j0 *= cols
                n = min(cols, length - j0)
            assert 0 < n <= edges
            runs.append((((g * n_rows + i0) * length + j0) * channels, n * channels))
    return runs


def _covers_once(runs: list, total: int) -> bool:
    covered = torch.zeros(total, dtype=torch.int32)
    for start, n in runs:
        covered[start:start + n] += 1
    return bool((covered == 1).all())


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_edge_feature_tiles_cover_every_element_once(cdt):
    """Each CTA of K1 writes one contiguous run of ef (whole rows of N pairs,
    or one chunk of a row longer than a tile) or of bf (a graph's bonds, or
    a chunk of them), and of K7 one run of the radial rows (whole rows of K
    slots, or a chunk): the runs cover every element exactly once, and their
    count is the layout's CTA count."""
    for G, N, B, nr in ((3, 19, 40, 32), (2, 44, 88, 5), (1, 300, 600, 32), (2, 257, 0, 1),
                        (1, 7, 3, 300)):
        ec = k1.EF_GEOM + nr
        edges = min(k1.THREADS, k1.STAGE_BYTES // (ec * k1.ESZ[cdt]))
        dense, bonds = _tile_runs(G, N, N, ec, edges), _tile_runs(G, 1, B, ec, edges)
        assert _covers_once(dense, G * N * N * ec) and _covers_once(bonds, G * B * ec)
        assert len(dense) + len(bonds) == k1.layout(G, N, B, nr, cdt)["ctas"]
    for G, N, K, nr in ((8, 512, 32, 32), (3, 203, 32, 32), (1, 30, 300, 32), (2, 21, 7, 5),
                        (1, 9, 32, 300)):
        slots = min(k1.THREADS, k1.STAGE_BYTES // (nr * k1.ESZ[cdt]))
        runs = _tile_runs(G, N, K, nr, slots)
        assert _covers_once(runs, G * N * K * nr)
        assert len(runs) == k7.layout(G, N, K, nr, cdt)["ctas"]


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_edge_features_fit_every_accepted_shape(cdt):
    """Every shape the wrappers accept launches: a CTA stages at most 256
    edges (one per thread) in under 48 KB, so it needs no opt-in to more
    shared memory and always fits the 227 KB a block may use; wider rows
    than the staging buffer, or more elements than 32-bit offsets reach,
    raise NotImplementedError naming their ROADMAP item."""
    for N in (1, 8, 19, 44, 48, 112, 128, 255, 256, 257, 600, 2048):
        for B in (0, N, 2 * N):
            for nr in (1, 8, 32, 64, 300, 1000):
                if 3 * (N * N + B) * (4 + nr) > k1.MAX_ELEMENTS:
                    with pytest.raises(NotImplementedError, match="32-bit offsets"):
                        k1.check_limits(3, N, B, nr, cdt)
                    continue
                k1.check_limits(3, N, B, nr, cdt)
                lay = k1.layout(3, N, B, nr, cdt)
                assert 1 <= lay["edges_per_tile"] <= lay["threads"] == 256
                assert lay["smem_bytes"] <= 48 * 1024 and lay["ctas"] >= 1, (N, B, nr, lay)
                for K in (1, 32, 256, 300):
                    k7.check_limits(3, N, K, nr, cdt)
                    lay = k7.layout(3, N, K, nr, cdt)
                    assert 1 <= lay["slots_per_tile"] <= 256 and lay["smem_bytes"] <= 48 * 1024
    for check, args in ((k1.check_limits, (1, 7700, 0, 32)), (k1.check_limits, (1, 8, 8, 20000)),
                        (k7.check_limits, (1, 8, 8, 20000))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
            check(*args, cdt)


def test_edge_feature_layouts_at_the_walk_shapes():
    """K1 at 4AA (N = 44, G = 256), 5AA (N = 112, G = 128) and the training
    shape (G = 32, N = 48) and K7 on the N = 512, G = 8 and N = 1024, G = 2
    chains and the ragged N = 203, G = 3 batch (K = 32): rows per tile, the
    largest tile, shared bytes (the rows, 16 bytes for the alignment shift,
    a f32 distance per row) and CTAs. The bf16 CTAs stay under 19 KB and the
    f32 ones under 36 KB, so shared memory leaves room for the six CTAs of
    256 threads per SM that 40 registers allow."""
    want = {
        (torch.bfloat16, 44): (5, 220, 16736, 2560), (torch.float32, 44): (5, 220, 32576, 2560),
        (torch.bfloat16, 112): (2, 224, 17040, 7296), (torch.float32, 112): (2, 224, 33168, 7296),
        (torch.bfloat16, 48): (5, 240, 18256, 352), (torch.float32, 48): (5, 240, 35536, 352),
    }
    for (cdt, N), (rows, cap, smem, ctas) in want.items():
        G = {44: 256, 112: 128, 48: 32}[N]
        esz = k1.ESZ[cdt]
        assert smem == (cap * 36 * esz + 31) // 16 * 16 + cap * 4
        assert k1.layout(G, N, 2 * N, 32, cdt) == dict(
            threads=256, smem_bytes=smem, edges_per_tile=cap, rows_per_tile=rows, ctas=ctas)
        assert _ctas_per_sm(smem) >= 6
    for cdt, smem in ((torch.bfloat16, 17424), (torch.float32, 33808)):
        for G, N, ctas in ((8, 512, 512), (2, 1024, 256), (3, 203, 78)):
            assert k7.layout(G, N, 32, 32, cdt) == dict(
                threads=256, smem_bytes=smem, slots_per_tile=256, rows_per_tile=8, ctas=ctas)
        assert _ctas_per_sm(smem) >= 6
