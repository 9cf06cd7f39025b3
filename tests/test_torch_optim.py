"""The port's optimizers (`jamun_tpu_torch/train/optim.py`) against optax:
adam, adamw (its defaults, and adamw.yaml's eps 0) and adagrad, each alone
and chained with a schedule as the CLI chains `model.lr_scheduler`, ten
steps on the same seeded gradients. Every parameter stays within 1e-6 of
optax's after every step (f32 rounding of the same operations; parameters of
order 1, updates of order the learning rate)."""

import functools
import math

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
        instantiate({"_target_": "optax.contrib.schedule_free_eval_params", "_partial_": True})

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
    # the rules built from optax's scale_by_* steps
    "adabelief": ("adabelief", dict(learning_rate=1e-2)),
    "adabelief_nesterov": ("adabelief", dict(learning_rate=1e-2, nesterov=True)),
    "adadelta": ("adadelta", dict(learning_rate=1.0, weight_decay=1e-2,
                                  weight_decay_mask=_DECAY_MASK)),
    "adadelta_no_learning_rate": ("adadelta", dict(rho=0.8)),
    "adafactor": ("adafactor", dict(learning_rate=1e-2)),
    "adafactor_factored_momentum": ("adafactor", dict(
        learning_rate=1e-2, min_dim_size_to_factor=2, momentum=0.9, weight_decay_rate=1e-3,
        weight_decay_mask=_DECAY_MASK)),
    "adafactor_unscaled": ("adafactor", dict(
        learning_rate=("cosine_decay_schedule", dict(init_value=2e-2, decay_steps=30)),
        multiply_by_parameter_scale=False, clipping_threshold=None, decay_offset=-3,
        min_dim_size_to_factor=3)),
    "adamaxw": ("adamaxw", dict(learning_rate=1e-2)),
    "adamaxw_mask": ("adamaxw", dict(learning_rate=1e-2, weight_decay=0.1, mask=_DECAY_MASK)),
    "adan": ("adan", dict(learning_rate=1e-2)),
    "adan_decay": ("adan", dict(learning_rate=1e-2, weight_decay=1e-2, mask="callable")),
    "amsgrad": ("amsgrad", dict(learning_rate=1e-2)),
    "amsgrad_mu_bf16": ("amsgrad", dict(learning_rate=1e-2, mu_dtype="bfloat16")),
    "fromage": ("fromage", dict(learning_rate=1e-2)),
    "fromage_schedule": ("fromage", dict(learning_rate=("linear_schedule", dict(
        init_value=2e-2, end_value=5e-3, transition_steps=12)))),
    "lamb": ("lamb", dict(learning_rate=1e-2)),
    "lamb_decay_mask": ("lamb", dict(learning_rate=1e-2, weight_decay=1e-2, mask=_DECAY_MASK)),
    "lamb_warmup_cosine": ("lamb", dict(learning_rate=("warmup_cosine_decay_schedule", dict(
        init_value=0.0, peak_value=2e-2, warmup_steps=5, decay_steps=20)))),
    "lars": ("lars", dict(learning_rate=1.0, weight_decay=1e-2)),
    "lars_nesterov_masks": ("lars", dict(learning_rate=1.0, weight_decay=1e-2,
                                         weight_decay_mask=_DECAY_MASK,
                                         trust_ratio_mask=_DECAY_MASK, nesterov=True,
                                         trust_coefficient=0.01, eps=1e-3)),
    "novograd": ("novograd", dict(learning_rate=1e-2)),
    "novograd_decay": ("novograd", dict(learning_rate=1e-2, weight_decay=1e-2, eps_root=1e-4)),
    "optimistic_adam": ("optimistic_adam", dict(learning_rate=1e-2)),
    "optimistic_adam_optimism": ("optimistic_adam", dict(learning_rate=1e-2, optimism=3e-3,
                                                         nesterov=False)),
    "optimistic_adam_v2": ("optimistic_adam_v2", dict(learning_rate=1e-2, beta=0.5)),
    "optimistic_gradient_descent": ("optimistic_gradient_descent", dict(learning_rate=1e-2)),
    "optimistic_gradient_descent_ab": ("optimistic_gradient_descent", dict(
        learning_rate=1e-2, alpha=0.5, beta=2.0)),
    "radam": ("radam", dict(learning_rate=1e-2)),
    "radam_nesterov": ("radam", dict(learning_rate=1e-2, nesterov=True, threshold=6.0)),
    "rprop": ("rprop", dict(learning_rate=1e-2)),
    "rprop_bounds": ("rprop", dict(learning_rate=5e-3, eta_minus=0.3, eta_plus=1.5,
                                   min_step_size=1e-3, max_step_size=2e-2)),
    "sign_sgd": ("sign_sgd", dict(learning_rate=1e-2)),
    "sign_sgd_exponential": ("sign_sgd", dict(learning_rate=("exponential_decay", dict(
        init_value=1e-2, transition_steps=4, decay_rate=0.8)))),
    "sm3": ("sm3", dict(learning_rate=1e-2)),
    "sm3_momentum": ("sm3", dict(learning_rate=1e-2, momentum=0.5)),
    "yogi": ("yogi", dict(learning_rate=1e-2)),
    "yogi_b": ("yogi", dict(learning_rate=1e-2, b1=0.8, b2=0.99, eps=1e-2)),
}
# sm3 keeps one accumulator per axis, none for a 0-d leaf (optax fails on
# one: `test_sm3_refuses_a_scalar_leaf`), and a 3-d leaf has three
CASE_SHAPES = {case: {"w": (5, 3), "b": (7,), "t": (4, 2, 3)} for case in ("sm3", "sm3_momentum")}


def _kwargs(kwargs: dict, side: str) -> dict:
    """The rule's arguments for optax (`side="jax"`) or the port: a
    schedule named by its factory, the mask tree or callable, the dtype by
    name (the port) or jnp's (optax)."""
    out = dict(kwargs)
    lr = out.get("learning_rate")
    if isinstance(lr, tuple):
        name, args = lr
        out["learning_rate"] = getattr(optax if side == "jax" else optim, name)(**args)
    if out.get("mask") == "callable":
        if side == "jax":
            out["mask"] = lambda params: jax.tree.map(lambda p: p.ndim > 0, params)
        else:
            out["mask"] = lambda tree: {"params": {k: v.ndim > 0 for k, v in tree["params"].items()}}
    for key in ("mu_dtype", "accumulator_dtype", "dtype_momentum"):
        if out.get(key) and side == "jax":
            out[key] = getattr(jnp, out[key])
    return out


@pytest.mark.parametrize("case", sorted(NEW_RULES))
def test_new_rules_match_optax_for_twenty_steps(case):
    """Each rule and option against optax on the same seeded gradients for
    20 steps: every parameter within 1e-6 of optax's after every step."""
    rule, kwargs = NEW_RULES[case]
    shapes = CASE_SHAPES.get(case, SHAPES)
    rng = np.random.default_rng(3)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
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
    moved = max(np.abs(np.asarray(jparams[k]) - init[k]).max() for k in shapes)
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
    # the rest of optax's schedules
    "polynomial_schedule": dict(init_value=1e-2, end_value=1e-4, power=2.5, transition_steps=40,
                                transition_begin=5),
    "piecewise_constant_schedule": dict(init_value=1e-2,
                                        boundaries_and_scales={10: 0.5, 25: 0.1, 40: 2.0}),
    "piecewise_interpolate_schedule": dict(interpolate_type="linear", init_value=1e-2,
                                           boundaries_and_scales={10: 0.5, 25: 0.1, 50: 3.0}),
    "piecewise_interpolate_schedule_by_cosine": dict(interpolate_type="cosine", init_value=1e-2,
                                                  boundaries_and_scales={15: 2.0, 45: 0.01}),
    "linear_onecycle_schedule": dict(transition_steps=50, peak_value=3e-2),
    "cosine_onecycle_schedule": dict(transition_steps=50, peak_value=3e-2, pct_start=0.2,
                                     div_factor=10.0, final_div_factor=100.0),
    "warmup_constant_schedule": dict(init_value=1e-4, peak_value=1e-2, warmup_steps=12),
    "warmup_exponential_decay_schedule": dict(init_value=0.0, peak_value=2e-2, warmup_steps=8,
                                              transition_steps=5, decay_rate=0.7,
                                              transition_begin=3, end_value=2e-3),
    "sgdr_schedule": dict(cosine_kwargs=[
        dict(init_value=1e-3, peak_value=2e-2, warmup_steps=4, decay_steps=20),
        dict(init_value=1e-3, peak_value=1e-2, warmup_steps=2, decay_steps=15, end_value=1e-4),
        dict(init_value=0.0, peak_value=5e-3, warmup_steps=5, decay_steps=30, exponent=2.0)]),
    "join_schedules": dict(schedules=[
        ("linear_schedule", dict(init_value=0.0, end_value=1e-2, transition_steps=10)),
        ("constant_schedule", dict(value=1e-2)),
        ("cosine_decay_schedule", dict(init_value=1e-2, decay_steps=30, alpha=0.1))],
        boundaries=[10, 20]),
}


def _schedule(name: str, mod):
    """The schedule `name` of SCHEDULES from `mod` (optax or the port); the
    schedules that join_schedules joins are built from `mod` too."""
    kwargs = dict(SCHEDULES[name])
    if "schedules" in kwargs:
        kwargs["schedules"] = [getattr(mod, n)(**a) for n, a in kwargs["schedules"]]
    return getattr(mod, name.replace("_staircase", "").replace("_by_cosine", ""))(**kwargs)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    """Each schedule against optax's value at steps 0..60 (f32 on both
    sides: 1e-6 relative)."""
    mine, theirs = _schedule(name, optim), _schedule(name, optax)
    for step in range(61):
        want = float(theirs(jnp.asarray(step, jnp.int32)))
        assert abs(mine(step) - want) <= 1e-6 * abs(want) + 1e-12, (name, step, mine(step), want)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_read_a_device_count(name):
    """At a count that is a tensor (the inner count under apply_if_finite)
    each schedule computes on the tensor's device with no host read and
    gives the host count's value within 1e-6 of the schedule's largest
    value (torch's f32 cos and pow may differ from numpy's by an ulp, which
    1 + cos near -1 magnifies)."""
    mine = _schedule(name, optim)
    want = [mine(step) for step in range(61)]
    scale = max(abs(w) for w in want)
    for step in range(61):
        got = mine(torch.tensor(step, dtype=torch.int32))
        got = float(got) if torch.is_tensor(got) else got
        assert abs(got - want[step]) <= 1e-6 * scale + 1e-12, (name, step, got, want[step])


def test_noisy_sgd_noise_scale():
    """add_noise's scale sqrt(eta / t^gamma) (t the step from 1), on a host
    count and on a device count, against optax's at steps 1..60."""
    p = torch.nn.Parameter(torch.zeros(4))
    for device_count in (False, True):
        opt = optim.noisy_sgd(1.0, eta=0.3)([("p", p)])
        add_noise = opt.steps[0]
        add_noise.noise = lambda rule, updates: [torch.ones_like(u) for u in updates]
        seen = []
        for t in range(60):
            group = opt.param_groups[0]
            group["count"] = torch.tensor(t, dtype=torch.int32) if device_count else t
            seen.append(float(add_noise(opt, group, [p], [torch.zeros(4)])[0][0]))
        want = [float(jnp.sqrt(0.3 / jnp.asarray(t, jnp.int32) ** 0.55)) for t in range(1, 61)]
        np.testing.assert_allclose(seen, want, rtol=1e-6)


def _walk(tx, opt, params: dict, grads: list, check=None):
    """optax's `tx` and the port's `opt` on the same gradients; the largest
    difference of any parameter after any step."""
    jparams = jax.tree.map(jnp.asarray, {k: v.detach().numpy().copy() for k, v in params.items()})
    jstate = tx.init(jparams)
    err = 0.0
    for i, g in enumerate(grads):
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in params.items():
            got, want = p.detach().numpy(), np.asarray(jparams[k])
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"step {i} {k}")
            keep = ~np.isnan(want)
            err = max(err, float(np.abs(got[keep] - want[keep]).max(initial=0.0)))
        if check is not None:
            check(i, jstate, opt)
    return err


def _seeded(n_steps: int, seed: int = 5, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(n_steps)]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    return params, grads


@pytest.mark.parametrize("schedule", [False, True], ids=["plain", "schedule"])
@pytest.mark.parametrize("use_grad_mean", [True, False], ids=["mean", "sum"])
def test_multisteps_matches_optax(use_grad_mean, schedule):
    """MultiSteps(adam, k = 3) accumulates three micro-steps and steps on
    the third, 20 micro-steps against optax's; with `model.lr_scheduler`
    chained after it, whose count advances every micro-step (JAX chains
    the MultiSteps object as it chains a rule). Through the resolver, as a
    config's nested `_target_` builds it."""
    params, grads = _seeded(20)
    cfg = {"_target_": "optax.MultiSteps", "_partial_": True, "every_k_schedule": 3,
           "use_grad_mean": use_grad_mean,
           "opt": {"_target_": "optax.adam", "learning_rate": 2e-2}}
    tx = optax.MultiSteps(optax.adam(2e-2), 3, use_grad_mean=use_grad_mean)
    factory = instantiate(cfg)()
    if schedule:
        tx = optax.chain(tx, optax.scale_by_schedule(jlr.linear_warmup_linear_decay(4, 30)))
        factory = functools.partial(factory, schedule=lr_schedules.linear_warmup_linear_decay(4, 30))
    opt = factory(list(params.items()))

    def check(i, jstate, opt):
        state = jstate[0] if schedule else jstate
        group = opt.param_groups[0]
        assert (group["mini_step"], group["gradient_step"]) == (int(state.mini_step),
                                                                int(state.gradient_step))
        assert group["count"] == int(state.inner_opt_state[0].count) == (i + 1) // 3
        assert group["schedule_count"] == i + 1

    assert _walk(tx, opt, params, grads, check) <= 1e-6


@pytest.mark.parametrize("max_errors", [1, 3])
def test_apply_if_finite_matches_optax(max_errors):
    """apply_if_finite(adam with a schedule as learning rate) with a NaN
    gradient at steps 4 and 5 of 20, and `model.lr_scheduler` chained after
    it: a rejected step keeps the parameters, the moments and the count
    (so the schedule and the bias corrections read it on the device); past
    `max_consecutive_errors` the NaN step is taken, as optax takes it."""
    params, grads = _seeded(20)
    for i in (3, 4):
        grads[i]["w"][1, 2] = np.nan
    lr = ("warmup_cosine_decay_schedule", dict(init_value=0.0, peak_value=2e-2, warmup_steps=3,
                                               decay_steps=25))
    tx = optax.chain(optax.apply_if_finite(optax.adam(**_kwargs(dict(learning_rate=lr), "jax")),
                                           max_errors),
                     optax.scale_by_schedule(jlr.linear_warmup_linear_decay(2, 30)))
    factory = instantiate({"_target_": "optax.apply_if_finite", "_partial_": True,
                           "max_consecutive_errors": max_errors,
                           "inner": {"_target_": "optax.adam", "learning_rate": {
                               "_target_": "optax.warmup_cosine_decay_schedule", **lr[1]}}})()
    opt = factory(list(params.items()),
                  schedule=lr_schedules.linear_warmup_linear_decay(2, 30))

    def check(i, jstate, opt):
        state, group = jstate[0], opt.param_groups[0]
        for key in ("notfinite_count", "last_finite", "total_notfinite"):
            assert torch.is_tensor(group[key]) and int(group[key]) == int(getattr(state, key)), key
        assert torch.is_tensor(group["count"])
        assert int(group["count"]) == int(state.inner_state[0].count)
        assert group["schedule_count"] == i + 1

    assert _walk(tx, opt, params, grads, check) <= 1e-6
    if max_errors == 3:  # both NaN steps rejected: everything stays finite
        assert all(torch.isfinite(p).all() for p in params.values())


def test_noisy_sgd_on_injected_noise(monkeypatch):
    """noisy_sgd with a schedule as learning rate against optax's on the
    same noise (drawn here and given to both sides), 20 steps."""
    import optax.tree

    params, grads = _seeded(20)
    rng = np.random.default_rng(11)
    noise = [{k: rng.standard_normal(np.shape(g[k])).astype(np.float32) for k in g} for g in grads]
    draws = iter(noise)
    monkeypatch.setattr(optax.tree, "random_like",
                        lambda key, target_tree, sampler: jax.tree.map(jnp.asarray, next(draws)))
    lr = ("exponential_decay", dict(init_value=3e-2, transition_steps=5, decay_rate=0.5))
    tx = optax.noisy_sgd(_kwargs(dict(learning_rate=lr), "jax")["learning_rate"], eta=0.2,
                         key=jax.random.key(0))
    opt = optim.noisy_sgd(_kwargs(dict(learning_rate=lr), "port")["learning_rate"],
                          eta=0.2)(list(params.items()))
    ported = iter(noise)
    opt.steps[0].noise = lambda rule, updates: [
        torch.from_numpy(v) for v in next(ported).values()]
    assert _walk(tx, opt, params, grads) <= 1e-6


def test_noisy_sgd_draws_from_its_seed():
    """The port's noise: N(0, 1) from a generator seeded with `key` (or
    `seed`), the same stream for the same seed, another for another, and
    resumed from a state dict."""
    def run(seed, steps=3, opt=None):
        p = torch.nn.Parameter(torch.zeros(1000))
        opt = opt or optim.noisy_sgd(1.0, eta=1.0, gamma=0.0, key=seed)([("p", p)])
        for _ in range(steps):
            p.grad = torch.zeros(1000)
            opt.step()
        return p.detach().clone(), opt

    a, opt = run(4)
    assert torch.equal(a, run(4)[0]) and not torch.equal(a, run(5)[0])
    assert abs(float(a.std()) / math.sqrt(3) - 1.0) < 0.1  # three unit draws summed
    sd = opt.state_dict()
    b, _ = run(4, steps=6)
    p = torch.nn.Parameter(a.clone())
    fresh = optim.noisy_sgd(1.0, eta=1.0, gamma=0.0, seed=4)([("p", p)])
    fresh.load_state_dict(sd)
    for _ in range(3):
        p.grad = torch.zeros(1000)
        fresh.step()
    assert torch.equal(p.detach(), b)


def test_sm3_refuses_a_scalar_leaf():
    """optax's sm3 fails on a 0-d leaf (IndexError: no accumulator); the
    port raises there too, naming the leaf."""
    params, grads = _seeded(1)
    tx = optax.sm3(1e-2)
    jparams = jax.tree.map(jnp.asarray, {k: v.detach().numpy() for k, v in params.items()})
    with pytest.raises(IndexError):
        tx.update(jax.tree.map(jnp.asarray, grads[0]), tx.init(jparams), jparams)
    opt = optim.sm3(1e-2)(list(params.items()))
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[0][k])
    with pytest.raises(ValueError, match="0-d leaf 'g'"):
        opt.step()


def test_resolver_maps_every_listed_optax_target():
    """Every optax target of the port's table resolves to its counterpart in
    `train/optim.py` (by `_partial_` factory, as a config names it): the 28
    rules, the 14 schedules and the two wrappers. `chain`, `named_chain`
    and `lookahead`, which JAX's trainer cannot run either, name their
    shared item; a name outside the table (a utility) names 'Other config
    targets'; lbfgs and polyak_sgd, which need the loss in their update,
    name their own item. (The transforms, combinators and optax.contrib:
    `tests/test_torch_optim_targets.py`.)"""
    from jamun_tpu_torch.config.instantiate import locate

    rules = optim.RULES
    assert len(rules) == 28 and len(optim.SCHEDULES) == 14
    assert {n.replace("_staircase", "").replace("_by_cosine", "") for n in SCHEDULES} == set(
        optim.SCHEDULES)
    for name in (*rules, *optim.SCHEDULES, *optim.WRAPPERS):
        assert locate(f"optax.{name}") is getattr(optim, name), name
    for name in rules:
        kwargs = {} if name in ("adadelta", "adafactor") else {"learning_rate": 1e-3}
        factory = instantiate({"_target_": f"optax.{name}", "_partial_": True, **kwargs})()
        opt = factory([("w", torch.nn.Parameter(torch.zeros(3)))])
        assert isinstance(opt, torch.optim.Optimizer), name
    for name, args in (("MultiSteps", {"every_k_schedule": 2}),
                       ("apply_if_finite", {"max_consecutive_errors": 2})):
        inner = "opt" if name == "MultiSteps" else "inner"
        opt = instantiate({"_target_": f"optax.{name}", "_partial_": True, **args,
                           inner: {"_target_": "optax.lamb", "learning_rate": 1e-3}})()(
            [("w", torch.nn.Parameter(torch.zeros(3)))])
        assert isinstance(opt.inner, optim._Chain) and opt.inner.alias == "lamb"
    sched = instantiate({"_target_": "optax.warmup_cosine_decay_schedule", "init_value": 0.0,
                         "peak_value": 1.0, "warmup_steps": 2, "decay_steps": 4})
    assert [sched(s) for s in (0, 1, 2)] == [0.0, 0.5, 1.0]
    pc = instantiate({"_target_": "optax.piecewise_constant_schedule", "init_value": 1.0,
                      "boundaries_and_scales": {3: 0.5, 5: 0.5}})  # YAML's integer keys
    assert [pc(s) for s in (2, 3, 5)] == [1.0, 0.5, 0.25]
    for name in ("optax.chain", "optax.lookahead", "optax.named_chain"):
        with pytest.raises(NotImplementedError, match="queue A, 'Targets JAX's trainer cannot run'"):
            instantiate({"_target_": name, "_partial_": True, "learning_rate": 1e-3})
    for name in ("optax.tree_map_params", "optax.contrib.schedule_free_eval_params"):
        with pytest.raises(NotImplementedError, match="queue A, 'Other config targets'"):
            instantiate({"_target_": name, "_partial_": True, "learning_rate": 1e-3})
    for name in ("optax.lbfgs", "optax.polyak_sgd"):
        with pytest.raises(NotImplementedError, match="queue A, 'Rules that need the loss'"):
            instantiate({"_target_": name, "_partial_": True})


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


@pytest.mark.parametrize("name", ["MultiSteps", "apply_if_finite", "noisy_sgd", "adafactor"])
def test_state_dict_round_trip_of_wrappers_and_chains(name):
    """A wrapper's state dict holds its rule's state and counts (one group,
    one state), a chain's its leaf-wise state and noisy_sgd's generator; each
    loads with `weights_only=True` into a fresh optimizer (the chained
    schedule's count too) and the two continue identically."""
    import io

    def make(params):
        factory = {
            "MultiSteps": lambda: optim.MultiSteps(optim.lamb(1e-2), 3),
            "apply_if_finite": lambda: optim.apply_if_finite(optim.adam(1e-2), 2),
            "noisy_sgd": lambda: optim.noisy_sgd(1e-2, key=3),
            "adafactor": lambda: optim.adafactor(1e-2, min_dim_size_to_factor=2),
        }[name]()
        return factory(list(params.items()), schedule=lr_schedules.linear_warmup_linear_decay(2, 20))

    params, grads = _seeded(10, shapes={"w": (5, 3), "b": (7,)})
    grads[2]["w"][0, 0] = np.nan if name == "apply_if_finite" else grads[2]["w"][0, 0]
    opt = make(params)
    for g in grads[:4]:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    twin = {k: torch.nn.Parameter(p.detach().clone()) for k, p in params.items()}
    fresh = make(twin)
    fresh.load_state_dict(torch.load(buf, weights_only=True))
    for g in grads[4:]:
        for side in (params, twin):
            for k, p in side.items():
                p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        fresh.step()
    for k in params:
        assert torch.equal(params[k], twin[k]), k
    assert fresh.param_groups[0]["schedule_count" if name in ("MultiSteps", "apply_if_finite")
                                 else "count"] == 10
