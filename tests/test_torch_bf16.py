"""The whole E3Conv in bf16 against JAX's bf16 XLA path, on the CPU.

JAX on the CPU cannot run its bf16 kernels (it refuses their bf16 x bf16 ->
f32 dots in interpret mode), but its XLA path (`use_pallas=False,
dtype=jnp.bfloat16`) runs. Both packages round at their own places, so
neither bf16 forward equals the other; each is held to JAX's f32 forward of
the same parameters and inputs, and the port's error must stay within twice
JAX's own and within 3e-2 of the output's max (the kernels' bf16 tolerance
on the card). The port runs its kernel path (the twins of the edge features
and of the fused ConvBlock) and its module-level plain path (`plain=True`).
Sizes and parameters as `tests/test_torch_model.py`: `16x0e + 8x1e`, two
layers, uvu; every leaf of JAX's initial parameters perturbed by 0.3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
CUTOFF = 0.9
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")


@functools.lru_cache(maxsize=None)
def _forwards(n_atoms: int, seed: int = 0):
    """JAX's f32 and bf16 forwards and the port's bf16 forwards (kernel
    path, plain path) of one set of perturbed parameters, as numpy."""
    kw = dict(num_graphs=2, max_nodes=n_atoms, max_bonds=2 * n_atoms, scale=0.35, seed=seed)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    params = JDenoiser(JE3Conv(**ARCH, use_pallas=False), JConfig(1.0, 0.5)).init(
        jax.random.PRNGKey(seed), jb
    )
    rng = np.random.default_rng(100 + seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )
    c_noise = np.array([np.log(SIGMA) / 4.0], dtype=np.float32)
    out = {}
    for name, dtype in (("jax f32", None), ("jax bf16", jnp.bfloat16)):
        arch = JE3Conv(**ARCH, use_pallas=False, dtype=dtype)
        out[name] = np.asarray(arch.apply(params, jb, jnp.asarray(c_noise), CUTOFF), dtype=np.float64)
    state = from_jax_params(params)
    for name, plain in (("kernel path", False), ("plain path", True)):
        arch = E3Conv(**ARCH, dtype=torch.bfloat16, plain=plain, device="cpu")
        arch.load_state_dict(state, strict=True)
        with torch.no_grad():
            got = arch(tb, torch.from_numpy(c_noise), CUTOFF)
        out[name] = got.to(torch.float64).numpy()
    return out


@pytest.mark.parametrize("path", ["kernel path", "plain path"])
@pytest.mark.parametrize("n_atoms", [8, 19])
def test_bf16_e3conv_within_jax_bf16_error(n_atoms, path):
    """max |port bf16 - JAX f32| <= 2 max |JAX bf16 - JAX f32| and <= 3e-2,
    both relative to max |JAX f32|."""
    out = _forwards(n_atoms)
    ref = out["jax f32"]
    scale = np.abs(ref).max()
    assert scale > 1e-2
    jax_err = np.abs(out["jax bf16"] - ref).max() / scale
    port_err = np.abs(out[path] - ref).max() / scale
    assert out[path].shape == ref.shape and np.isfinite(out[path]).all()
    assert 0 < jax_err  # JAX's bf16 path does round
    assert port_err <= 2 * jax_err, (port_err, jax_err)
    assert port_err <= 3e-2, port_err
