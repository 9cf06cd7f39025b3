"""The port's optimizers (`jamun_tpu_torch/train/optim.py`) against optax:
adam, adamw (its defaults, and adamw.yaml's eps 0) and adagrad, each alone
and chained with a schedule as the CLI chains `model.lr_scheduler`, ten
steps on the same seeded gradients. Every parameter stays within 1e-6 of
optax's after every step (f32 rounding of the same operations; parameters of
order 1, updates of order the learning rate)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamun_tpu.train import lr_schedules as jlr
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.train import lr_schedules
from jamun_tpu_torch.train import optim

SHAPES = {"w": (5, 3), "b": (7,), "g": ()}
RULES = {
    "adam": dict(learning_rate=1e-2),
    "adamw": dict(learning_rate=1e-2),
    "adamw_eps0": dict(learning_rate=1e-2, eps=0.0),
    "adagrad": dict(learning_rate=5e-2),
}


def _optax(rule: str, kwargs: dict, schedule: bool):
    base = getattr(optax, rule.split("_")[0])(**kwargs)
    if schedule:
        return optax.chain(base, optax.scale_by_schedule(jlr.linear_warmup_linear_decay(3, 12)))
    return base


def _port(rule: str, kwargs: dict, schedule: bool):
    # through the config resolver, as `_partial_: true` configs reach it
    factory = instantiate({"_target_": f"optax.{rule.split('_')[0]}", "_partial_": True, **kwargs})()
    if schedule:
        return lambda params: factory(params, schedule=lr_schedules.linear_warmup_linear_decay(3, 12))
    return factory


@pytest.mark.parametrize("schedule", [False, True], ids=["plain", "schedule"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_optimizer_matches_optax(rule, schedule):
    kwargs = RULES[rule]
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(10)]

    tx = _optax(rule, kwargs, schedule)
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = _port(rule, kwargs, schedule)(list(params.values()))
    for g in grads:
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{rule} {k}")
    moved = max(np.abs(np.asarray(jparams[k]) - init[k]).max() for k in SHAPES)
    assert moved > 1e-2, moved  # ten steps did move the parameters
    assert opt.param_groups[0]["count"] == 10


def test_defaults_and_missing_gradients():
    """optax's defaults (torch's own AdamW decays by 1e-2 and its Adagrad
    starts at 0 with eps outside the root), and a parameter without a
    gradient takes the update of a zero gradient, as an optax leaf does."""
    assert optim.adamw(1e-3).keywords["weight_decay"] == 1e-4
    assert optim.adam(1e-3).keywords == dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                                             mu_dtype=None, nesterov=False)
    assert optim.adagrad(1e-3).keywords == dict(lr=1e-3, initial_accumulator_value=0.1, eps=1e-7)
    with pytest.raises(NotImplementedError, match="queue A, 'Other config targets'"):
        instantiate({"_target_": "optax.lamb", "_partial_": True, "learning_rate": 1e-3})

    init = np.linspace(-1, 1, 6, dtype=np.float32)
    tx = optax.adamw(1e-2)
    jparams, jstate = jnp.asarray(init), tx.init(jnp.asarray(init))
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = optim.adamw(1e-2)([p])
    for _ in range(3):
        updates, jstate = tx.update(jnp.zeros(6), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step()  # p.grad is None
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams), rtol=0, atol=1e-7)
    assert not np.array_equal(np.asarray(jparams), init)  # the decay moved them


def test_state_dict_round_trip():
    """The optimizer state (moments and the step count) loads back with
    `weights_only=True` and continues identically."""
    import io

    rng = np.random.default_rng(1)
    a = torch.nn.Parameter(torch.from_numpy(rng.standard_normal(4).astype(np.float32)))
    b = torch.nn.Parameter(a.detach().clone())
    opt_a, opt_b = optim.adam(1e-2)([a]), optim.adam(1e-2)([b])
    a.grad = torch.ones(4)
    opt_a.step()
    buf = io.BytesIO()
    torch.save(opt_a.state_dict(), buf)
    buf.seek(0)
    with torch.no_grad():
        b.copy_(a)
    opt_b.load_state_dict(torch.load(buf, weights_only=True))
    assert opt_b.param_groups[0]["count"] == 1
    for p in (a, b):
        p.grad = torch.full((4,), 0.5)
    opt_a.step()
    opt_b.step()
    assert torch.equal(a, b)


# ---- the rest of optax's rules, options and schedules ----

_DECAY_MASK = {"w": True, "b": False, "g": True}
NEW_RULES = {
    "sgd": ("sgd", dict(learning_rate=5e-2)),
    "sgd_momentum": ("sgd", dict(learning_rate=5e-2, momentum=0.9)),
    "sgd_nesterov": ("sgd", dict(learning_rate=5e-2, momentum=0.9, nesterov=True)),
    "sgd_nesterov_bf16": ("sgd", dict(learning_rate=5e-2, momentum=0.9, nesterov=True,
                                      accumulator_dtype="bfloat16")),
    "rmsprop": ("rmsprop", dict(learning_rate=1e-2)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=1e-2, centered=True, momentum=0.8,
                                         nesterov=True)),
    "rmsprop_bias_correction": ("rmsprop", dict(learning_rate=1e-2, bias_correction=True)),
    "rmsprop_eps_outside": ("rmsprop", dict(learning_rate=1e-2, eps_in_sqrt=False,
                                            initial_scale=1.0, momentum=0.5)),
    "adamax": ("adamax", dict(learning_rate=1e-2)),
    "nadam": ("nadam", dict(learning_rate=1e-2)),
    "nadamw": ("nadamw", dict(learning_rate=1e-2, weight_decay=1e-2)),
    "adam_nesterov": ("adam", dict(learning_rate=1e-2, nesterov=True)),
    "adamw_nesterov": ("adamw", dict(learning_rate=1e-2, nesterov=True)),
    "adam_mu_bf16": ("adam", dict(learning_rate=1e-2, mu_dtype="bfloat16")),
    "adamw_mask_bf16": ("adamw", dict(learning_rate=1e-2, weight_decay=0.1, mask=_DECAY_MASK,
                                      mu_dtype="bfloat16")),
    "adamw_mask_callable": ("adamw", dict(learning_rate=1e-2, weight_decay=0.1,
                                          mask="callable")),
    "lion": ("lion", dict(learning_rate=1e-3)),
    "lion_mask_bf16": ("lion", dict(learning_rate=1e-3, weight_decay=0.1, mask=_DECAY_MASK,
                                    mu_dtype="bfloat16")),
    "adam_warmup_cosine": ("adam", dict(learning_rate=("warmup_cosine_decay_schedule", dict(
        init_value=0.0, peak_value=2e-2, warmup_steps=5, decay_steps=20, end_value=1e-3)))),
    "sgd_exponential": ("sgd", dict(learning_rate=("exponential_decay", dict(
        init_value=5e-2, transition_steps=3, decay_rate=0.7, staircase=True)), momentum=0.9)),
    "adagrad_linear": ("adagrad", dict(learning_rate=("linear_schedule", dict(
        init_value=5e-2, end_value=1e-2, transition_steps=15, transition_begin=2)))),
}


def _kwargs(kwargs: dict, side: str) -> dict:
    """The rule's arguments for optax (`side="jax"`) or the port: a
    schedule named by its factory, the mask tree or callable, the dtype by
    name (the port) or jnp's (optax)."""
    out = dict(kwargs)
    lr = out["learning_rate"]
    if isinstance(lr, tuple):
        name, args = lr
        out["learning_rate"] = getattr(optax if side == "jax" else optim, name)(**args)
    if out.get("mask") == "callable":
        if side == "jax":
            out["mask"] = lambda params: jax.tree.map(lambda p: p.ndim > 0, params)
        else:
            out["mask"] = lambda tree: {"params": {k: v.ndim > 0 for k, v in tree["params"].items()}}
    for key in ("mu_dtype", "accumulator_dtype"):
        if out.get(key) and side == "jax":
            out[key] = getattr(jnp, out[key])
    return out


@pytest.mark.parametrize("case", sorted(NEW_RULES))
def test_new_rules_match_optax_for_twenty_steps(case):
    """Each rule and option against optax on the same seeded gradients for
    20 steps: every parameter within 1e-6 of optax's after every step."""
    rule, kwargs = NEW_RULES[case]
    rng = np.random.default_rng(3)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(20)]
    tx = getattr(optax, rule)(**_kwargs(kwargs, "jax"))
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = getattr(optim, rule)(**_kwargs(kwargs, "port"))(list(params.items()))
    for g in grads:
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{case} {k}")
    moved = max(np.abs(np.asarray(jparams[k]) - init[k]).max() for k in SHAPES)
    assert moved > 1e-2, moved
    assert opt.param_groups[0]["count"] == 20


SCHEDULES = {
    "constant_schedule": dict(value=3e-3),
    "linear_schedule": dict(init_value=1e-2, end_value=2e-4, transition_steps=17, transition_begin=3),
    "cosine_decay_schedule": dict(init_value=2e-2, decay_steps=25, alpha=0.1, exponent=1.5),
    "warmup_cosine_decay_schedule": dict(init_value=1e-4, peak_value=3e-2, warmup_steps=7,
                                         decay_steps=30, end_value=1e-3),
    "exponential_decay": dict(init_value=1e-2, transition_steps=4, decay_rate=0.8,
                              transition_begin=2),
    "exponential_decay_staircase": dict(init_value=1e-2, transition_steps=4, decay_rate=0.8,
                                        staircase=True, end_value=5e-3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    """Each schedule against optax's value at steps 0..40 (f32 on both
    sides: 1e-6 relative)."""
    factory = name.replace("_staircase", "")
    mine = getattr(optim, factory)(**SCHEDULES[name])
    theirs = getattr(optax, factory)(**SCHEDULES[name])
    for step in range(41):
        want = float(theirs(jnp.asarray(step, jnp.int32)))
        assert abs(mine(step) - want) <= 1e-6 * abs(want) + 1e-12, (name, step, mine(step), want)


def test_resolver_maps_every_listed_optax_target():
    """Every optax target of the port's table resolves to its counterpart in
    `train/optim.py` (by `_partial_` factory, as a config names it), and an
    unlisted one names 'Other config targets'."""
    from jamun_tpu_torch.config.instantiate import locate

    rules = ("adam", "adamw", "adagrad", "nadam", "nadamw", "adamax", "lion", "sgd", "rmsprop")
    for name in (*rules, *{n.replace("_staircase", "") for n in SCHEDULES}):
        assert locate(f"optax.{name}") is getattr(optim, name), name
    for name in rules:
        factory = instantiate({"_target_": f"optax.{name}", "_partial_": True, "learning_rate": 1e-3})()
        opt = factory([torch.nn.Parameter(torch.zeros(3))])
        assert isinstance(opt, torch.optim.Optimizer), name
    sched = instantiate({"_target_": "optax.warmup_cosine_decay_schedule", "init_value": 0.0,
                         "peak_value": 1.0, "warmup_steps": 2, "decay_steps": 4})
    assert [sched(s) for s in (0, 1, 2)] == [0.0, 0.5, 1.0]
    for name in ("optax.lamb", "optax.adabelief", "optax.chain"):
        with pytest.raises(NotImplementedError, match="queue A, 'Other config targets'"):
            instantiate({"_target_": name, "_partial_": True, "learning_rate": 1e-3})


def test_mask_needs_names_and_reads_the_flax_tree():
    """A mask is keyed by the flax names: a factory bound to bare tensors
    refuses it; `optim.bind` gives a module's names, and a tree under
    "params" (JAX's parameter tree) masks the decay of those leaves."""
    module = torch.nn.Module()
    module.Dense_0 = torch.nn.Module()
    module.Dense_0.kernel = torch.nn.Parameter(torch.ones(2, 2))
    module.Dense_0.bias = torch.nn.Parameter(torch.ones(2))
    factory = optim.adamw(1e-1, weight_decay=0.5,
                          mask={"params": {"Dense_0": {"kernel": True, "bias": False}}})
    with pytest.raises(ValueError, match="named_parameters"):
        factory(list(module.parameters()))
    opt = optim.bind(factory, module)
    assert opt.decay_mask == [True, False]
    opt.step()  # zero gradients: the decay alone moves the kernel
    assert torch.all(module.Dense_0.kernel < 1) and torch.equal(module.Dense_0.bias, torch.ones(2))
