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
optimizer states the port cannot place, and `config.pkl`'s unpickler. Then
every rule of the port (the nine of optax's first slice, with their
options, the rest of optax's rules, MultiSteps and apply_if_finite, and a
sample of optax.contrib's rules and the combinators built from configs),
each with a chained schedule, resumes from JAX's state after seven steps;
the leaf-wise rules, muon and the combinators step a scanned E3Conv as
JAX's; and lbfgs / polyak_sgd fail in JAX's train step and raise in the
port. (Every target of optax.contrib and the combinators resumes on a
small tree in tests/test_torch_optim_targets.py.)"""

import collections
import functools
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.contrib
import pytest
import torch

from jamun_tpu.config.instantiate import instantiate as j_instantiate
from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.train import lr_schedules as jlr
from jamun_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from jamun_tpu.train.state import TrainState as JTrainState
from jamun_tpu.train.state import create_train_state as j_create_train_state
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.cmdline.sample import load_config_pickle
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params, load_jax_train_state
from jamun_tpu_torch.train import lr_schedules, optim, optim_contrib, optim_transforms
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


# ---- every rule of the port: JAX's state after seven steps, then one more ----

def _mask_tree(params) -> dict:
    """A decay mask of JAX's parameter tree: kernels decay, the rest not."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: getattr(path[-1], "key", "") != "bias", params)


def _cases() -> dict:
    """name -> (optax rule, the port's factory, step of a NaN gradient or
    None); each runs with `model.lr_scheduler` chained after it."""
    lr_s = ("warmup_cosine_decay_schedule", dict(init_value=0.0, peak_value=LR, warmup_steps=3,
                                                 decay_steps=30))
    mask = "mask"  # the decay mask of the parameter tree, built per side

    def rule(name, **kw):
        def side(mod):
            def build(params=None):
                args = dict(kw)
                for k, v in args.items():
                    if isinstance(v, tuple):
                        args[k] = getattr(mod, v[0])(**v[1])
                    elif v == mask:
                        args[k] = _mask_tree(params)
                    elif k in ("mu_dtype",) and mod is optax:
                        args[k] = getattr(jnp, v)
                return getattr(mod, name)(**args)
            return build
        return side(optax), side(optim)

    cases = {
        "adam": rule("adam", learning_rate=LR),
        "adam_nesterov_mu_bf16": rule("adam", learning_rate=LR, nesterov=True, mu_dtype="bfloat16"),
        "adam_lr_schedule": rule("adam", learning_rate=lr_s),
        "adamw": rule("adamw", learning_rate=LR, eps=0.0),
        "adamw_mask": rule("adamw", learning_rate=LR, weight_decay=1e-2, mask=mask),
        "adamw_no_decay": rule("adamw", learning_rate=LR, weight_decay=0.0),
        "nadam": rule("nadam", learning_rate=LR),
        "nadamw": rule("nadamw", learning_rate=LR, weight_decay=1e-2),
        "adagrad": rule("adagrad", learning_rate=LR),
        "adagrad_lr_schedule": rule("adagrad", learning_rate=lr_s),
        "adamax": rule("adamax", learning_rate=LR),
        "lion": rule("lion", learning_rate=LR),
        "lion_mask": rule("lion", learning_rate=LR, weight_decay=1e-2, mask=mask),
        "sgd": rule("sgd", learning_rate=LR),
        "sgd_nesterov_lr_schedule": rule("sgd", learning_rate=lr_s, momentum=0.9, nesterov=True),
        "rmsprop": rule("rmsprop", learning_rate=LR),
        "rmsprop_centered": rule("rmsprop", learning_rate=LR, centered=True, momentum=0.9,
                                 bias_correction=True),
        "adabelief": rule("adabelief", learning_rate=LR),
        "adadelta": rule("adadelta", learning_rate=1.0, weight_decay=1e-3,
                         weight_decay_mask=mask),
        "adafactor": rule("adafactor", learning_rate=LR),
        "adafactor_factored_momentum": rule("adafactor", learning_rate=LR,
                                            min_dim_size_to_factor=8, momentum=0.9,
                                            weight_decay_rate=1e-3),
        "adamaxw": rule("adamaxw", learning_rate=LR),
        "adan": rule("adan", learning_rate=LR, weight_decay=1e-3, mask=mask),
        "amsgrad": rule("amsgrad", learning_rate=lr_s),
        "fromage": rule("fromage", learning_rate=LR),
        "fromage_lr_schedule": rule("fromage", learning_rate=lr_s),
        "lamb": rule("lamb", learning_rate=LR, weight_decay=1e-3),
        "lars": rule("lars", learning_rate=LR, weight_decay=1e-3, trust_ratio_mask=mask),
        "noisy_sgd": rule("noisy_sgd", learning_rate=LR),
        "novograd": rule("novograd", learning_rate=LR),
        "optimistic_adam": rule("optimistic_adam", learning_rate=LR),
        "optimistic_adam_v2": rule("optimistic_adam_v2", learning_rate=lr_s),
        "optimistic_gradient_descent": rule("optimistic_gradient_descent", learning_rate=LR),
        "radam": rule("radam", learning_rate=LR),
        "rprop": rule("rprop", learning_rate=LR),
        "sign_sgd": rule("sign_sgd", learning_rate=LR),
        "yogi": rule("yogi", learning_rate=LR),
    }
    out = {k: (j, p, None) for k, (j, p) in cases.items()}
    out["MultiSteps_adam_3"] = (
        lambda params=None: optax.MultiSteps(optax.adam(LR), 3),
        lambda params=None: optim.MultiSteps(optim.adam(LR), 3), None)
    out["apply_if_finite_lamb_2"] = (
        lambda params=None: optax.apply_if_finite(optax.lamb(LR), 2),
        lambda params=None: optim.apply_if_finite(optim.lamb(LR), 2), 3)

    # optax.contrib and the combinators, each built by both resolvers from one
    # config (masks and labels: trees of JAX's parameter names, as a YAML gives
    # them); muon resumes in tests/test_torch_optim_targets.py (its Newton-Schulz
    # takes JAX over a minute here, op by op) and steps a scanned E3Conv below
    def config(make):
        return (lambda params=None: j_instantiate(make(params))(),
                lambda params=None: instantiate(make(params))(), None)

    def labels(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, x: "a" if x.ndim == 2 else "s", params)

    adamw = {"_target_": "optax.adamw", "learning_rate": LR, "weight_decay": 1e-2}
    sgd = {"_target_": "optax.sgd", "learning_rate": LR, "momentum": 0.9}
    for name, make in {
        "contrib_prodigy": lambda p: _opt("optax.contrib.prodigy", estim_lr0=1e-3),
        "contrib_dadapt_adamw": lambda p: _opt("optax.contrib.dadapt_adamw", estim_lr0=1e-3),
        "contrib_schedule_free_adamw": lambda p: _opt("optax.contrib.schedule_free_adamw",
                                                      learning_rate=LR, warmup_steps=3),
        "contrib_mechanize": lambda p: _opt("optax.contrib.mechanize",
                                            base_optimizer={"_target_": "optax.adam",
                                                            "learning_rate": LR}),
        "contrib_dog": lambda p: _opt("optax.contrib.dog"),
        "contrib_cocob": lambda p: _opt("optax.contrib.cocob", learning_rate=0.1),
        "contrib_sam": lambda p: _opt("optax.contrib.sam", optimizer=sgd, adv_optimizer=sgd,
                                      sync_period=3),
        "masked": lambda p: _opt("optax.masked", inner=adamw, mask=_mask_tree(p)),
        "multi_transform": lambda p: _opt("optax.multi_transform",
                                          transforms={"a": adamw, "s": sgd},
                                          param_labels=labels(p)),
        "flatten": lambda p: _opt("optax.flatten", inner={"_target_": "optax.adam",
                                                          "learning_rate": LR}),
        "inject_hyperparams": lambda p: {"_target_": "optax.inject_hyperparams", "inner_factory": {
            "_target_": "optax.adam", "_partial_": True, "learning_rate": LR}},
        "scale_by_rms": lambda p: _opt("optax.scale_by_rms", bias_correction=True),
    }.items():
        out[name] = config(make)
    return out


def _opt(target: str, **kwargs) -> dict:
    """`model.optim` as a config names it: `_partial_: true`."""
    return {"_target_": target, "_partial_": True, **kwargs}


CASES = _cases()


def _noise_trees(params, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(np.shape(p)).astype(np.float32)),
                         params) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rule_resumes_from_a_jax_state_after_seven_steps(name, tmp_path, monkeypatch):
    """JAX's TrainState after 7 updates of the rule chained with
    `model.lr_scheduler` (as `cmdline/common.build_optimizer` chains it),
    written by JAX's `save_checkpoint`, restored by the port; the next
    update on the same gradients gives JAX's parameters within 1e-6 of
    each leaf's max. noisy_sgd takes the same injected noise on both sides,
    and its state loads from memory: flax cannot write a JAX PRNG key, so
    JAX's trainer writes no checkpoint of it."""
    import optax.tree

    jrule, port_rule, nan_step = CASES[name]
    _, _, params0, key, _ = _jax_model()
    rng = np.random.default_rng(100)
    params = jax.tree.map(
        lambda p: p + jnp.asarray(rng.standard_normal(np.shape(p)).astype(np.float32) * 0.3), params0)
    grads = _noise_trees(params, 8, 7)
    if nan_step is not None:
        # a NaN in the 0-d output gain's gradient
        grads[nan_step] = jax.tree.map(lambda g: g * jnp.nan if g.ndim == 0 else g, grads[nan_step])
    noise = _noise_trees(params, 8, 9)
    draws = iter(noise)
    monkeypatch.setattr(optax.tree, "random_like",
                        lambda key, target_tree, sampler: next(draws))
    tx = optax.chain(jrule(params), optax.scale_by_schedule(_sched(jlr)))
    opt_state = tx.init(params)
    for g in grads[:7]:
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    ema = jax.tree.map(lambda p: p + 0.01, params)
    jstate = JTrainState(step=jnp.asarray(7, jnp.int32), params=params, opt_state=opt_state,
                         ema_params=ema, rng=key)

    den, state = _port_state(lambda: functools.partial(port_rule(params),
                                                       schedule=_sched(lr_schedules)))
    if name == "noisy_sgd":
        load_jax_train_state(flax.serialization.to_state_dict(jstate), state)
        ported = iter(noise[7:])
        state.optimizer.steps[0].noise = lambda rule, updates: [
            from_jax_params(tree)[n].clone() for tree in [next(ported)] for n in rule.names]
    else:
        path = str(tmp_path / "last.ckpt")
        j_save_checkpoint(path, jstate)
        restore_checkpoint(path, state)
    assert state.step == 7
    group = state.optimizer.param_groups[0]
    want_count = {"MultiSteps_adam_3": 2, "apply_if_finite_lamb_2": 6}.get(name, 7)
    if "count" in group:  # a rule's own (a combinator's rules keep theirs under a prefix)
        assert int(group["count"]) == want_count, (group["count"], want_count)

    updates, _ = tx.update(grads[7], opt_state, params)
    want = _flat(optax.apply_updates(params, updates))
    g = from_jax_params(grads[7])
    for n, p in state.module.named_parameters():
        p.grad = g[n].clone()
    state.optimizer.step()
    for n, p in state.module.named_parameters():
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        assert float(np.abs(p.detach().numpy() - want[n]).max()) <= 1e-6 * scale, n


def test_sm3_state_places_per_axis():
    """sm3 (which E3Conv's 0-d output gain keeps from JAX's trainer, in JAX
    too): optax's per-axis accumulators of a [4, 3] kernel and a [3] bias
    after 7 steps load into a module of those flax names, and the next
    update equals optax's within 1e-6."""
    module = torch.nn.Module()
    module.Dense_0 = torch.nn.Module()
    rng = np.random.default_rng(0)
    params = {"params": {"Dense_0": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                                     "bias": rng.standard_normal(3).astype(np.float32)}}}
    for k, v in params["params"]["Dense_0"].items():
        setattr(module.Dense_0, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    jparams = jax.tree.map(jnp.asarray, params)
    tx = optax.chain(optax.sm3(LR), optax.scale_by_schedule(_sched(jlr)))
    jstate = tx.init(jparams)
    grads = _noise_trees(jparams, 8, 3)
    for g in grads[:7]:
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(from_jax_params(jparams)[n])
    opt = optim.bind(functools.partial(optim.sm3(LR), schedule=_sched(lr_schedules)), module)
    from jamun_tpu_torch.params import _load_jax_opt_state

    _load_jax_opt_state(flax.serialization.to_state_dict(jstate), module, opt, 7)
    assert [tuple(opt.state[module.Dense_0.kernel][f"mu_{i}"].shape) for i in (0, 1)] == [(4,), (3,)]
    updates, _ = tx.update(grads[7], jstate, jparams)
    want = from_jax_params(optax.apply_updates(jparams, updates))
    g = from_jax_params(grads[7])
    for n, p in module.named_parameters():
        p.grad = g[n]
    opt.step()
    for n, p in module.named_parameters():
        assert float((p.detach() - want[n]).abs().max()) <= 1e-6 * float(want[n].abs().max()), n


# ---- the leaf-wise rules on a scanned E3Conv ----

SCANNED_RULES = {
    "lamb": (lambda: optax.lamb(LR, weight_decay=1e-3), lambda: optim.lamb(LR, weight_decay=1e-3)),
    "adafactor": (lambda: optax.adafactor(LR, min_dim_size_to_factor=4, momentum=0.9),
                  lambda: optim.adafactor(LR, min_dim_size_to_factor=4, momentum=0.9)),
    "novograd": (lambda: optax.novograd(LR, weight_decay=1e-3),
                 lambda: optim.novograd(LR, weight_decay=1e-3)),
    "lars": (lambda: optax.lars(LR, weight_decay=1e-3), lambda: optim.lars(LR, weight_decay=1e-3)),
    "fromage": (lambda: optax.fromage(LR), lambda: optim.fromage(LR)),
    # flax's leaves decide muon's labels (a stacked kernel has 3 axes: Adam; a
    # stacked bias 2: Newton-Schulz on the stack), the masks and flatten's order
    "contrib_muon": (lambda: optax.contrib.muon(LR), lambda: optim_contrib.muon(LR)),
    "selective_transform": (
        lambda: optax.selective_transform(optax.adamw(LR), freeze_mask=_stacked_kernels()),
        lambda: optim_transforms.selective_transform(optim.adamw(LR),
                                                     freeze_mask=_stacked_kernels())),
    "multi_transform": (
        lambda: optax.multi_transform(
            {"a": optax.lamb(LR), "s": optax.sgd(LR, momentum=0.9)},
            lambda p: jax.tree.map(lambda x: "a" if x.ndim == 3 else "s", p)),
        lambda: optim_transforms.multi_transform(
            {"a": optim.lamb(LR), "s": optim.sgd(LR, momentum=0.9)}, _three_axes_label)),
    "flatten": (lambda: optax.flatten(optax.adam(LR)),
                lambda: optim_transforms.flatten(optim.adam(LR))),
    "contrib_prodigy": (lambda: optax.contrib.prodigy(estim_lr0=1e-3),
                        lambda: optim_contrib.prodigy(estim_lr0=1e-3)),
}


def _stacked_kernels() -> dict:
    """A freeze mask (a tree of bools, as a config gives it): the scanned
    layers' stacked kernels (3 axes)."""
    return jax.tree.map(lambda x: bool(x.ndim == 3), _scanned_jax()[0])


def _three_axes_label(tree):
    return {k: _three_axes_label(v) if isinstance(v, dict) else ("a" if v.ndim == 3 else "s")
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _scanned_jax():
    jb = j_make_test_batch(**BATCH)
    jden = JDenoiser(JE3Conv(**ARCH, scan_layers=True, use_pallas=False),
                     JConfig(**CONFIG, add_fixed_ones=True))
    params = jden.init(jax.random.PRNGKey(0), jb)
    # moved off flax's init, where some leaves are zero (no scale to hold them to)
    params = jax.tree.map(lambda p, n: p + 0.3 * n, params, _noise_trees(params, 1, 4)[0])
    grad = jax.jit(jax.grad(lambda p: jden.training_loss(p, jax.random.PRNGKey(1), jb, SIGMA)[0]))
    return params, grad


@pytest.mark.parametrize("name", sorted(SCANNED_RULES))
def test_leafwise_rules_on_a_scanned_e3conv(name):
    """A scanned E3Conv (its hidden layers one stacked leaf each in flax)
    trained 5 steps by JAX on its loss's gradients, and the port's scanned
    E3Conv from the same weights stepped by the same rule on the same
    gradients: the trust ratios, novograd's nu and adafactor's factors and
    block RMS read the stacked leaves, so every parameter stays within 1e-6
    of each leaf's max of JAX's after every step."""
    from jamun_tpu_torch.params import to_jax_params

    params, grad = _scanned_jax()
    assert "Scan_HiddenLayer_0" in params["params"]
    jrule, port_rule = SCANNED_RULES[name]
    tx = jrule()
    state = tx.init(params)
    arch = E3Conv(**ARCH, scan_layers=True, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    opt = optim.bind(port_rule(), arch)
    assert opt.names.count(
        "Scan_HiddenLayer_0.ConvBlock_0.Conv_0.radial_nn.Dense_0.kernel") == ARCH["n_layers"]
    for step in range(5):
        g = grad(params)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        gp = from_jax_params(g)
        for n, p in arch.named_parameters():
            p.grad = gp[n].clone()
        opt.step()
        got = _flat(to_jax_params(arch.state_dict(), scan_layers=True))
        want = _flat(params)
        for n, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got[n] - w).max()) <= 1e-6 * scale, (step, n)


def test_sm3_on_e3conv_fails_in_jax_and_the_port():
    """optax.sm3 cannot update E3Conv's 0-d `output_gain` (IndexError in
    JAX's update); the port's sm3 refuses it too."""
    params, grad = _scanned_jax()
    tx = optax.sm3(LR)
    with pytest.raises(IndexError):
        tx.update(grad(params), tx.init(params), params)
    arch = E3Conv(**ARCH, scan_layers=True, device="cpu")
    opt = optim.bind(optim.sm3(LR), arch)
    with pytest.raises(ValueError, match="0-d leaf 'output_gain'"):
        opt.step()


@pytest.mark.parametrize("name", ["lbfgs", "polyak_sgd"])
def test_rules_that_need_the_loss_fail_in_jax_and_raise_in_the_port(name):
    """JAX's `make_train_step` calls `update(grads, state, params)`, which
    lbfgs (value, grad, value_fn) and polyak_sgd (value) refuse with a
    TypeError; the port's resolver raises NotImplementedError naming the
    item."""
    from jamun_tpu.train import distributions as jdist
    from jamun_tpu.train.state import make_train_step as j_make_train_step

    from jamun_tpu_torch.config.instantiate import instantiate

    jden, jb, _, _, _ = _jax_model()
    tx = getattr(optax, name)()
    jstate = j_create_train_state(jden, tx, jb, seed=0)
    step = j_make_train_step(jden, tx, jdist.ConstantSigma(SIGMA))
    with pytest.raises(TypeError, match="value"):
        step(jstate, jb)
    with pytest.raises(NotImplementedError, match="queue A, 'Rules that need the loss'"):
        instantiate({"_target_": f"optax.{name}", "_partial_": True})
