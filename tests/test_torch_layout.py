"""The Python mirrors of the kernels' shared-memory reckoning and K3's launch
shape (`ops/cuda/conv_block.smem_bytes`, `ops/cuda/e3_stack.stack_shape`),
on the CPU. On the card `tests/test_torch_cuda.py` holds them to the
libraries' own query functions (`conv_block_occupancy`, `e3_stack_shape`);
here they are held to what the kernels must be able to launch: every shape
the wrappers accept fits the 227 KB a block may use, and the flagship shapes
take the launch shapes the design notes give.
"""

import pytest
import torch

from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import e3_stack as k3

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
