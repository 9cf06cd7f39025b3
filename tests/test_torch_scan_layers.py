"""`E3Conv(scan_layers=True)`: JAX's scanned parameter tree in the port (CPU,
f32).

JAX runs the hidden layers under `nn.scan`, and flax keeps their
parameters in one subtree, `Scan_HiddenLayer_0`, each leaf stacked on a
leading axis of length `n_layers`. The port keeps its `_HiddenLayer_k`
modules; `from_jax_params` slices that subtree into them and
`to_jax_params(..., scan_layers=True)` stacks them back. JAX's side runs
its XLA path (`use_pallas=False`); the port runs its kernel path, whose
plain twins run on the CPU. The parameters are JAX's init, every leaf
perturbed with seeded numpy noise (JAX's scanned init splits its key per
layer, so the two sides are compared from the same parameters, never from
the same seed). Each tolerance is written beside its check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from jamun_tpu.train.state import TrainState as JTrainState
from jamun_tpu.train.state import create_train_state as j_create_train_state
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cuda import e3_stack as k3
from jamun_tpu_torch.params import SCANNED, from_jax_params, to_jax_params
from jamun_tpu_torch.train import optim
from jamun_tpu_torch.train.checkpoints import restore_checkpoint
from jamun_tpu_torch.train.state import create_train_state
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="32x0e + 16x1e", n_layers=3, tensor_product="uvu")
BATCH = dict(num_graphs=2, max_nodes=12, nodes_per_graph=[12, 10], max_bonds=24, scale=0.35, seed=0)
CONFIG = dict(max_radius=1.0, average_squared_distance=0.5)
C_NOISE = float(np.log(SIGMA) / 4.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturbed(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32)),
        tree,
    )


def _jax_scanned(neighbor_mode="dense", seed=0):
    """JAX's scanned E3Conv (XLA path), its perturbed parameters and batch."""
    jb = j_make_test_batch(**BATCH)
    jm = JE3Conv(**ARCH, use_pallas=False, scan_layers=True, neighbor_mode=neighbor_mode)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), jb, jnp.asarray([C_NOISE]), 1.0), 50 + seed)
    return jm, params, jb


def _flat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_flax_names_the_scanned_subtree():
    """JAX's `init` puts the hidden layers under `Scan_HiddenLayer_0`, each
    leaf with a leading axis of n_layers; the port's modules keep their
    `_HiddenLayer_k` names, as many leaves as JAX's unstacked."""
    _, params, _ = _jax_scanned()
    tree = params["params"]
    assert SCANNED == "Scan_HiddenLayer_0" and SCANNED in tree
    assert not any(k.startswith("_HiddenLayer_") for k in tree)
    stacked = _flat(tree[SCANNED])
    assert stacked and all(v.shape[0] == ARCH["n_layers"] for v in stacked.values())
    port = E3Conv(**ARCH, scan_layers=True, device="cpu")
    names = set(port.state_dict())
    mapped = from_jax_params(params)
    assert set(mapped) == names
    assert sum(n.startswith("_HiddenLayer_") for n in names) == ARCH["n_layers"] * len(stacked)


def test_round_trip_gives_the_scanned_tree_exactly():
    """`to_jax_params(from_jax_params(tree), scan_layers=True)` is JAX's
    tree: the same paths, every leaf bit for bit; without the flag the
    layers stay unstacked (the model says which, not the shapes)."""
    _, params, _ = _jax_scanned()
    back = to_jax_params(from_jax_params(params), scan_layers=True)
    want, got = _flat(params), _flat(back)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        assert np.array_equal(got[k].view(np.uint32), v.view(np.uint32)), k
    # flax's top-level order: the scanned subtree where the layers were
    assert list(back["params"]) == list(params["params"])
    plain = to_jax_params(from_jax_params(params))["params"]
    assert SCANNED not in plain and "_HiddenLayer_2" in plain


@pytest.mark.parametrize("path", ["layerwise", "sparse"])
def test_scanned_model_matches_jax(path):
    """The port's E3Conv built from JAX's scanned tree against JAX's scanned
    model: the forward (1e-5 of its max) and the gradients of <out, w> for a
    fixed w with respect to every parameter (1e-4 of each leaf's max, JAX's
    stacked gradients sliced per layer). "layerwise" is the dense path (the
    port: K1's, K2's and K4's twins), "sparse" the capped-neighbour path."""
    mode = "dense" if path == "layerwise" else "nbr"
    jm, params, jb = _jax_scanned(mode, seed=1)
    port = E3Conv(**ARCH, scan_layers=True, neighbor_mode=mode, device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    tb = make_test_batch(**BATCH, device="cpu")
    w = np.random.default_rng(7).standard_normal(tuple(jb.pos.shape[:2]) + (3,)).astype(np.float32)

    def j_loss(p):
        out = jm.apply(p, jb, jnp.asarray([C_NOISE]), 1.0, training=True)
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    out = port(tb, torch.tensor([C_NOISE]), 1.0)
    (out * torch.from_numpy(w)).sum().backward()
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-2
    assert _rel(out.detach().numpy(), want) < 1e-5
    want_g = {k: v.numpy() for k, v in from_jax_params(jgrads).items()}
    got_g = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    live = [n for n, g in want_g.items() if np.abs(g).max() > 0]
    assert sum(n.startswith("_HiddenLayer_2.") for n in live) >= 15
    for name in live:
        assert _rel(got_g[name], want_g[name]) < 1e-4, (name, _rel(got_g[name], want_g[name]))


def test_scanned_checkpoint_restores(tmp_path):
    """A checkpoint that JAX's `save_checkpoint` writes for a scanned model
    (Adam after one update on seeded gradients, EMA moved off the
    parameters) restores in the port: parameters, EMA, Adam's mu and nu
    (each sliced per layer) and the count bit for bit, the step carried."""
    jb = j_make_test_batch(**BATCH)
    jden = JDenoiser(JE3Conv(**ARCH, use_pallas=False, scan_layers=True), JConfig(**CONFIG))
    opt = optax.adam(2e-3)
    state = j_create_train_state(jden, opt, jb, seed=0)
    rng = np.random.default_rng(3)
    noise = lambda s: lambda p: jnp.asarray(rng.standard_normal(np.shape(p)).astype(np.float32) * s)  # noqa: E731
    params = jax.tree.map(lambda p: p + noise(0.3)(p), state.params)
    updates, opt_state = opt.update(jax.tree.map(noise(1.0), params), opt.init(params), params)
    params = optax.apply_updates(params, updates)
    ema = jax.tree.map(lambda p: p + noise(0.05)(p), params)
    jstate = JTrainState(step=jnp.asarray(9, jnp.int32), params=params, opt_state=opt_state,
                         ema_params=ema, rng=state.rng)
    assert SCANNED in params["params"]
    path = str(tmp_path / "last.ckpt")
    j_save_checkpoint(path, jstate)

    den = Denoiser(E3Conv(**ARCH, scan_layers=True, device="cpu", seed=1), DenoiserConfig(**CONFIG))
    pstate = create_train_state(den, optim.adam(2e-3), seed=1, device="cpu")
    restore_checkpoint(path, pstate)
    assert pstate.step == 9

    def same(got: torch.Tensor, want: np.ndarray, what: str):
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want, np.float32).view(np.uint32)), what

    for tree, module in ((params, pstate.module), (ema, pstate.ema)):
        sd = module.state_dict()
        for k, v in from_jax_params(tree).items():
            same(sd[k], v.numpy(), k)
    group = pstate.optimizer.param_groups[0]
    assert group["count"] == int(opt_state[0].count) == 1
    for key in ("mu", "nu"):
        want = from_jax_params(getattr(opt_state[0], key))
        for name, p in pstate.module.named_parameters():
            same(pstate.optimizer.state[p][key], want[name].numpy(), f"{key} {name}")


def test_scan_layers_keeps_the_stack_kernel_off(monkeypatch):
    """Under `fused_stack=True` a scanned model never takes the whole-model
    kernel (JAX's `_stack_ok` is False under scan: `tests/test_e3_stack.py`);
    the unscanned model on the same weights does, and the scanned one's
    output equals the unscanned layerwise model's bit for bit."""
    calls = []
    inner = k3.e3conv_stack
    monkeypatch.setattr(k3, "e3conv_stack", lambda *a, **k: calls.append(1) or inner(*a, **k))
    _, params, _ = _jax_scanned(seed=2)
    tb = make_test_batch(**BATCH, device="cpu")
    outs = {}
    for name, kw in (("scanned", dict(scan_layers=True, fused_stack=True)),
                     ("stack", dict(fused_stack=True)), ("layerwise", {})):
        model = E3Conv(**ARCH, device="cpu", **kw).requires_grad_(False)
        model.load_state_dict(from_jax_params(params), strict=True)
        calls.clear()
        with torch.no_grad():
            outs[name] = model(tb, torch.tensor([C_NOISE]), 1.0)
        assert len(calls) == (1 if name == "stack" else 0), name
    torch.testing.assert_close(outs["scanned"], outs["layerwise"], rtol=0, atol=0)
