"""The atom-only embeddings of the port against JAX (CPU, f32):
`SimpleAtomEmbedding` and `CoarseGrainedBeadEmbedding` exactly on carried
parameters, and `E3Conv(use_residue_information=False)` (the IDRome-CG
chains' arch) at a narrow width, output and gradients.

Parameters: JAX's `init`, every leaf perturbed with seeded numpy noise, then
carried across by `params.from_jax_params`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.models.embeddings import (
    CoarseGrainedBeadEmbedding as JBeads,
    SimpleAtomEmbedding as JSimple,
)
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.models.embeddings import CoarseGrainedBeadEmbedding, SimpleAtomEmbedding
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu",
            use_residue_information=False)
BATCH = dict(num_graphs=2, max_nodes=19, max_bonds=38, scale=0.35, seed=3)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )


@pytest.mark.parametrize("which", ["simple", "beads"])
def test_embedding_equals_jax(which):
    """The lookup of every atom's row, bit for bit; the parameter names are
    flax's (`Embed_0/embedding`)."""
    jb = j_make_test_batch(**BATCH)
    tb = make_test_batch(**BATCH, device="cpu")
    if which == "simple":
        jmod, mod = JSimple(embedding_dim=12), SimpleAtomEmbedding(12)
    else:
        jmod, mod = JBeads(bead_embedding_dim=6), CoarseGrainedBeadEmbedding(6)
    assert int(tb.atom_type_index.max()) < 10  # inside the bead table too
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jb), 1)
    state = from_jax_params(params)
    assert sorted(state) == ["Embed_0.embedding"]
    mod.load_state_dict(state, strict=True)
    assert mod.irreps_out == type(mod.irreps_out)(str(jmod.irreps_out))
    want = np.asarray(jmod.apply(params, jb))
    with torch.no_grad():
        got = mod(tb).numpy()
    np.testing.assert_array_equal(got, want)


def _setup(seed=0):
    jb = j_make_test_batch(**BATCH)
    tb = make_test_batch(**BATCH, device="cpu")
    jmod = JE3Conv(**ARCH, use_pallas=False)
    c_noise = np.array([np.log(0.04) / 4.0], np.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(seed), jb, jnp.asarray(c_noise), 1.0), 10 + seed)
    mod = E3Conv(**ARCH, device="cpu")
    mod.load_state_dict(from_jax_params(params), strict=True)
    return jmod, params, jb, mod, tb, c_noise


def test_e3conv_without_residue_information_builds_jax_tree():
    """The port's E3Conv names the embedder as flax does, and its parameter
    tree is JAX's, leaf for leaf."""
    jmod, params, _, mod, _, _ = _setup()
    assert sorted(mod.state_dict()) == sorted(from_jax_params(params))
    assert "SimpleAtomEmbedding_0.Embed_0.embedding" in mod.state_dict()
    assert not hasattr(mod, "AtomEmbeddingWithResidueInformation_0")
    assert mod.embedder.irreps_out.sv_shape()[0] == 56  # 8 + 8 + 32 + 8


@pytest.mark.parametrize("plain", [False, True])
def test_e3conv_without_residue_information_matches_jax(plain):
    """Output within 1e-5 of the max, and the gradients of a fixed linear
    functional of it within 1e-4 of each leaf's max (the kernel path's
    plain twins and the module-level plain path)."""
    jmod, params, jb, mod, tb, c_noise = _setup()
    if plain:
        mod = E3Conv(**ARCH, plain=True, device="cpu")
        mod.load_state_dict(from_jax_params(params), strict=True)
    weights = np.random.default_rng(5).standard_normal((jb.pos.shape[0], jb.pos.shape[1], 3))
    weights = weights.astype(np.float32)

    def j_loss(p):
        out = jmod.apply(p, jb, jnp.asarray(c_noise), 1.0, training=True)
        return jnp.sum(out * weights), out

    (_, want), want_g = jax.value_and_grad(j_loss, has_aux=True)(params)
    want = np.asarray(want)
    got = mod(tb, torch.from_numpy(c_noise), 1.0)
    torch.sum(got * torch.from_numpy(weights)).backward()
    got = got.detach().numpy()
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    want_g = from_jax_params(want_g)
    for name, p in mod.named_parameters():
        w = want_g[name].numpy()
        # a leaf the output does not reach gets no gradient in torch, zeros in JAX
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name
    # the atom types' table received a gradient
    assert np.abs(want_g["SimpleAtomEmbedding_0.Embed_0.embedding"].numpy()).max() > 0
