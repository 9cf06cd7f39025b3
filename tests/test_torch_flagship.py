"""The port at the flagship width against JAX (CPU, f32): `E3Conv` and
`Denoiser.score` with `120x0e + 32x1e`, five layers, edge_attr_dim 64
(`jamun_tpu/config/defaults/model/arch/e3conv_separable.yaml`), on two
graphs of 44 and 41 atoms, against JAX's XLA path (`use_pallas=False`).

The port runs three ways: its plain path (`plain=True`, library ops on
`dense_edge_data`), its layerwise kernel path (K1's and K2's plain twins on
the CPU) and `pallas_variant="plane"` (K9's twin in each hidden layer).
Parameters: JAX `Denoiser.init`, every leaf perturbed with N(0, 0.1^2)
seeded numpy noise, output gain 1. (At 0.3, the perturbation the narrow
tests use, this width's activations grow to the hundreds and every f32
evaluation, JAX's included, sits about 2e-4 from an f64 one.) Tolerance:
1e-4 of the max, the other parity tests' bound for a whole model, on the
network output and on the score (which multiplies xhat's error by
1 / sigma^2).
"""

import jax
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
FLAGSHIP = dict(irreps_hidden="120x0e + 32x1e", n_layers=5, edge_attr_dim=64, tensor_product="uvu")
BATCH = dict(num_graphs=2, max_nodes=44, nodes_per_graph=[44, 41], max_bonds=88, scale=0.35)
PATHS = {
    "plain": dict(plain=True),
    "layerwise kernels": dict(),
    "plane": dict(pallas_variant="plane"),
}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's parameters (perturbed), its network output and its score."""
    jb = j_make_test_batch(**BATCH)
    jden = JDenoiser(JE3Conv(**FLAGSHIP, use_pallas=False), JConfig(1.0, 0.5))
    params = jden.init(jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(7)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )
    params["params"]["output_gain"] = np.float32(1.0)  # the network's share of xhat is visible
    c_noise = np.asarray([np.log(SIGMA) / 4.0], np.float32)
    out = np.asarray(jax.jit(jden.arch.apply)(params, jb, c_noise, 0.9))
    score = np.asarray(jax.jit(lambda p: jden.score(p, jb, SIGMA))(params))
    return params, c_noise, out, score


@pytest.mark.parametrize("path", list(PATHS))
def test_flagship_width_matches_jax(jax_reference, path):
    params, c_noise, want_out, want_score = jax_reference
    arch = E3Conv(**FLAGSHIP, device="cpu", **PATHS[path])
    arch.load_state_dict(from_jax_params(params), strict=True)
    arch.requires_grad_(False)
    den = Denoiser(arch, DenoiserConfig(1.0, 0.5))
    tb = make_test_batch(**BATCH, device="cpu")
    with torch.no_grad():
        out = arch(tb, torch.from_numpy(c_noise), 0.9).numpy()
        score = den.score(tb, SIGMA).numpy()
    assert out.shape == want_out.shape == (2, 44, 3)
    assert np.abs(want_out).max() > 1e-2 and np.abs(want_score).max() > 1.0
    assert _rel(out, want_out) < 1e-4
    assert _rel(score, want_score) < 1e-4
