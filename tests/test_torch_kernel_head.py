"""The EquivariantMLP head of the kernel path (`E3Conv._kernel_head`) under
autograd, against JAX's `E3Conv._transposed_head` on the CPU: the sigmoid
of its gates is evaluated as XLA evaluates it, 1 / (1 + exp(-t)) op by op,
and its derivative must be JAX's, s (1 - s). Before, the quotient's own
derivative gave NaN wherever exp(-t) overflowed (a gate pre-activation
below about -88), which stopped a 30-step flagship training run on the card
at its 29th step. Here gate pre-activations reach -300: the port's
gradients are finite and within the dtype's tolerance of JAX's (f32 1e-5,
bf16 3e-2 of each leaf's max), and the forward is JAX's (bit for bit in
bf16, within 1e-5 of the max in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.irreps import Irreps as JIrreps
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params

torch.set_num_threads(2)
S, V, N = 16, 8, 8
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=1, tensor_product="uvu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_head_gradient_matches_jax_past_overflow(dtype):
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jb = j_make_test_batch(num_graphs=2, max_nodes=N, max_bonds=16, scale=0.35)
    jm = JE3Conv(**ARCH, use_pallas=True, dtype=jdt)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb, jnp.zeros((1,)), 1.2)
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )
    # the gates' weights scaled so that their pre-activations span about +-300
    head = params["params"]["EquivariantMLP_0"]["EquivariantMLPBlock_0"]["IrrepsLinear_0"]
    head["w_0_1"] = head["w_0_1"] * 60.0
    x = rng.standard_normal((2, N, S + 3 * V)).astype(np.float32)
    xT = np.zeros((2, 16 + 3 * 16, N), np.float32)  # kernel-native [G, Sp + 3Vp, N]
    xT[:, :S] = x[..., :S].transpose(0, 2, 1)
    xv = x[..., S:].reshape(2, N, V, 3)
    for c in range(3):
        xT[:, 16 + 16 * c : 16 + 16 * c + V] = xv[..., c].transpose(0, 2, 1)
    proj = rng.standard_normal((2, N, 3)).astype(np.float32)

    def jhead(p):
        return jm.apply(p, jnp.asarray(xT), JIrreps("16x0e + 8x1e"), JIrreps("1x1e"),
                        method=JE3Conv._transposed_head)

    want = np.asarray(jax.jit(jhead)(params).astype(jnp.float32))
    jgrads = from_jax_params(jax.jit(jax.grad(
        lambda p: jnp.sum(jhead(p).astype(jnp.float32) * proj)))(params))
    arch = E3Conv(**ARCH, dtype=tdt, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    pre = torch.from_numpy(x[..., :S]) @ arch.EquivariantMLP_0.EquivariantMLPBlock_0.IrrepsLinear_0.w_0_1.detach() / 4
    assert float(pre.min()) < -150  # exp(-t) overflows in both dtypes
    got = arch._kernel_head(torch.from_numpy(x))
    if dtype == "bfloat16":  # the same rounding points (tests/test_torch_model.py)
        np.testing.assert_array_equal(got.detach().float().numpy(), want)
    else:  # f32 products summed in another order
        assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    (got.float() * torch.from_numpy(proj)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 3e-2
    for name, p in arch.named_parameters():
        if not name.startswith("EquivariantMLP_0"):
            continue
        # the head's scalars reach no `1x1e` output: no gradient on either side
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        w = jgrads[name].numpy()
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), name
