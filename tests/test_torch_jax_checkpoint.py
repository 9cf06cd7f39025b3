"""The port reads checkpoints that JAX wrote (CPU, f32): JAX's
`create_train_state` and one `optimizer.update` on seeded gradients (so
that mu, nu and count are not zero), EMA parameters that differ from the
parameters, `save_checkpoint`; then the port's `restore_checkpoint` into a
fresh state of the same arch (`16x0e + 8x1e`, 2 layers, uvu). Parameters,
EMA parameters and the optimizer's state are bit for bit, the step carries,
the EMA score is JAX's within 1e-5 of the max, and one more update on the
same gradients on both sides gives the same parameters within 1e-6 of
each leaf's max (so the counts are placed where the bias correction and the
schedule read them). Also: a bf16 leaf, chunked arrays, unknown bytes,
optimizer states the port cannot place, and `config.pkl`'s unpickler."""

import collections
import functools
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.train import lr_schedules as jlr
from jamun_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from jamun_tpu.train.state import TrainState as JTrainState
from jamun_tpu.train.state import create_train_state as j_create_train_state
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.cmdline.sample import load_config_pickle
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.train import lr_schedules, optim
from jamun_tpu_torch.train.checkpoints import (
    checkpoint_format,
    read_flax_msgpack,
    restore_checkpoint,
    save_checkpoint,
)
from jamun_tpu_torch.train.state import create_train_state
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")
CONFIG = dict(max_radius=1.0, average_squared_distance=0.3)
BATCH = dict(num_graphs=2, max_nodes=12, nodes_per_graph=[12, 10], max_bonds=24, scale=0.35, seed=0)
LR = 2e-3


def _sched(mod):
    return mod.linear_warmup_linear_decay(3, 40)


# (name, JAX optimizer, the port's factory): the rules of train/optim.py and
# a chained schedule, as `cmdline/common.build_optimizer` builds them
OPTIMIZERS = {
    "adam": (lambda: optax.adam(LR), lambda: optim.adam(LR)),
    "adamw": (lambda: optax.adamw(LR, eps=0.0), lambda: optim.adamw(LR, eps=0.0)),
    "adagrad": (lambda: optax.adagrad(LR), lambda: optim.adagrad(LR)),
    "adam+schedule": (
        lambda: optax.chain(optax.adam(LR), optax.scale_by_schedule(_sched(jlr))),
        lambda: functools.partial(optim.adam(LR), schedule=_sched(lr_schedules)),
    ),
}


@functools.lru_cache(maxsize=None)
def _jax_model():
    """JAX's denoiser, a batch, initial parameters and key, and the jitted
    score (built once: the init and the score compile in seconds each)."""
    jb = j_make_test_batch(**BATCH)
    jden = JDenoiser(JE3Conv(**ARCH, use_pallas=False), JConfig(**CONFIG))
    state = j_create_train_state(jden, optax.adam(LR), jb, seed=0)
    return jden, jb, state.params, state.rng, jax.jit(jden.score)


def _jax_state(opt, step=7):
    """A JAX TrainState after one update on seeded gradients, the EMA leaves
    moved off the parameters."""
    _, _, params0, key, _ = _jax_model()
    rng = np.random.default_rng(100)

    def noise(scale):
        return lambda p: jnp.asarray(rng.standard_normal(np.shape(p)).astype(np.float32) * scale)

    params = jax.tree.map(lambda p: p + noise(0.3)(p), params0)
    grads = jax.tree.map(noise(1.0), params)
    updates, opt_state = opt.update(grads, opt.init(params), params)
    params = optax.apply_updates(params, updates)
    ema = jax.tree.map(lambda p: p + noise(0.05)(p), params)
    return JTrainState(step=jnp.asarray(step, jnp.int32), params=params, opt_state=opt_state,
                       ema_params=ema, rng=key)


def _port_state(factory, seed=1):
    arch = E3Conv(**ARCH, device="cpu", seed=seed)
    den = Denoiser(arch, DenoiserConfig(**CONFIG))
    return den, create_train_state(den, factory(), seed=seed, device="cpu")


def _flat(tree) -> dict:
    return {k: v.numpy() for k, v in from_jax_params(tree).items()}


def _opt_leaves(opt_state):
    """{"mu"/"nu"/"sum_of_squares": flax tree} and the rule's count of an
    optax state of OPTIMIZERS."""
    rule = opt_state[0]
    if not hasattr(rule, "_fields"):  # the chain with scale_by_schedule
        rule = rule[0]
    leaves = {k: getattr(rule, k) for k in ("mu", "nu", "sum_of_squares") if hasattr(rule, k)}
    return leaves, int(rule.count) if "count" in rule._fields else None


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_restore_jax_checkpoint_bit_for_bit(name, tmp_path):
    jopt_f, port_f = OPTIMIZERS[name]
    jopt = jopt_f()
    jstate = _jax_state(jopt)
    path = str(tmp_path / "last.ckpt")
    j_save_checkpoint(path, jstate)
    with open(path, "rb") as f:
        assert checkpoint_format(f.read(4)) == "flax"

    den, state = _port_state(port_f)
    assert restore_checkpoint(path, state) is state
    assert state.step == 7
    for tree, module in ((jstate.params, state.module), (jstate.ema_params, state.ema)):
        want, got = _flat(tree), module.state_dict()
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            assert np.array_equal(got[k].numpy().view(np.uint32), v.view(np.uint32)), k
    leaves, count = _opt_leaves(jstate.opt_state)
    names = [n for n, _ in state.module.named_parameters()]
    for key, tree in leaves.items():
        want = _flat(tree)
        for n, p in zip(names, state.module.parameters()):
            assert np.array_equal(state.optimizer.state[p][key].numpy().view(np.uint32),
                                  want[n].view(np.uint32)), (key, n)
    assert state.optimizer.param_groups[0]["count"] == (count if count is not None else 7)

    # the EMA score, f32: JAX's within 1e-5 of the max
    tb = make_test_batch(**BATCH, device="cpu")
    _, jb, _, _, jscore = _jax_model()
    want = np.asarray(jscore(jstate.ema_params, jb, SIGMA))
    with torch.no_grad():
        got = Denoiser(state.ema, den.config).score(tb, SIGMA).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    # one more update on the same gradients
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(np.shape(p)).astype(np.float32)),
                         jstate.params)
    updates, _ = jopt.update(grads, jstate.opt_state, jstate.params)
    want = _flat(optax.apply_updates(jstate.params, updates))
    g = from_jax_params(grads)
    for n, p in state.module.named_parameters():
        p.grad = g[n].clone()
    state.optimizer.step()
    for n, p in state.module.named_parameters():
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        assert float(np.abs(p.detach().numpy() - want[n]).max()) <= 1e-6 * scale, n


def test_torch_checkpoint_still_restores(tmp_path):
    """The port's own format takes its path, as before."""
    _, state = _port_state(OPTIMIZERS["adam"][1], seed=3)
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, state)
    with open(path, "rb") as f:
        assert checkpoint_format(f.read(4)) == "torch"
    _, fresh = _port_state(OPTIMIZERS["adam"][1], seed=4)
    restore_checkpoint(path, fresh)
    for k, v in state.module.state_dict().items():
        assert torch.equal(fresh.module.state_dict()[k], v), k


def test_bf16_leaf_round_trips(tmp_path):
    """A bfloat16 leaf (numpy has no such dtype) becomes a torch.bfloat16
    tensor of the same bits; float32, int32 and a numpy scalar keep theirs."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32), jnp.bfloat16)
    tree = {"w": x, "f": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i": np.asarray([1, -2], np.int32), "s": np.float32(2.5)}
    path = tmp_path / "bf16.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    got = read_flax_msgpack(str(path))
    assert got["w"].dtype == torch.bfloat16 and tuple(got["w"].shape) == (3, 5)
    assert np.array_equal(got["w"].view(torch.int16).numpy(), np.asarray(x).view(np.int16))
    assert got["f"].dtype == np.float32 and np.array_equal(got["f"], tree["f"])
    assert got["i"].dtype == np.int32 and np.array_equal(got["i"], tree["i"])
    assert got["s"] == np.float32(2.5) and got["s"].dtype == np.float32


def test_chunked_array_and_unknown_bytes_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    path = tmp_path / "chunked.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize({"a": {"b": np.zeros(100, np.float32)}}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A, 'The sample CLI'"):
        read_flax_msgpack(str(path))
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"\x00\x01junk")
    _, state = _port_state(OPTIMIZERS["adam"][1])
    with pytest.raises(ValueError, match="neither a torch.save zip nor a flax msgpack map"):
        restore_checkpoint(str(bad), state)


def test_optimizer_states_the_port_cannot_place_raise(tmp_path):
    """adagrad's state into an Adam raises (a structure mismatch); a chained
    schedule whose count differs from the rule's raises NotImplementedError
    (the port keeps one count); an optax rule the port lacks raises."""
    jstate = _jax_state(optax.adagrad(LR))
    path = str(tmp_path / "adagrad.ckpt")
    j_save_checkpoint(path, jstate)
    _, state = _port_state(OPTIMIZERS["adam"][1])
    with pytest.raises(ValueError, match="does not match"):
        restore_checkpoint(path, state)

    jstate = _jax_state(OPTIMIZERS["adam+schedule"][0]())
    rule, sched = jstate.opt_state
    jstate = jstate.replace(opt_state=(rule, sched._replace(count=sched.count + 3)))
    path = str(tmp_path / "sched.ckpt")
    j_save_checkpoint(path, jstate)
    _, state = _port_state(OPTIMIZERS["adam+schedule"][1])
    with pytest.raises(NotImplementedError, match="'Other config targets'"):
        restore_checkpoint(path, state)

    jstate = _jax_state(optax.sgd(LR, momentum=0.9))
    path = str(tmp_path / "sgd.ckpt")
    j_save_checkpoint(path, jstate)
    den, _ = _port_state(OPTIMIZERS["adam"][1])
    state = create_train_state(den, lambda ps: torch.optim.SGD(ps, lr=LR), device="cpu")
    with pytest.raises(NotImplementedError, match="'Other config targets'"):
        restore_checkpoint(path, state)


def test_config_pickle_reads_plain_dicts_only(tmp_path):
    plain = {"model": {"arch": {"_target_": "jamun_tpu.models.E3Conv", "n_layers": 2},
                       "average_squared_distance": 0.25, "sizes": (1, 2), "tags": {"a"}},
             "__global_package__": True, "x": [1.5, None, complex(1, 2)]}
    path = tmp_path / "config.pkl"
    for protocol in (2, pickle.HIGHEST_PROTOCOL):
        path.write_bytes(pickle.dumps(plain, protocol=protocol))
        assert load_config_pickle(str(path)) == plain
    for bad in ({"model": collections.OrderedDict(a=1)}, {"model": JConfig(**CONFIG)}):
        path.write_bytes(pickle.dumps(bad))
        with pytest.raises(pickle.UnpicklingError, match="plain dict"):
            load_config_pickle(str(path))
