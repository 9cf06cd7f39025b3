"""The port's CUDA kernels against their plain twins on the card, at small
shapes. CUDA kernels have no CPU mode, so these tests skip without a GPU;
`python3 chip_smoke.py` runs the same comparison at the main path's shapes.
Run on a GPU machine with
`python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`
(`tests/conftest.py` imports JAX, which that machine need not have).

Tolerance (max |kernel - plain| / max |plain|): f32 1e-4 (summation order
only), bf16 3e-2 (an f32 sum that differs in its last bits can round an
intermediate to the neighbouring bf16 value).
"""

import pytest
import torch

from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.cuda import edge_features as k1
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
    model = E3Conv(irreps_hidden="24x0e + 8x1e", n_layers=1, dtype=cdt, device=cuda, seed=0)
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
