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
    assert optim.adam(1e-3).keywords == dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)
    assert optim.adagrad(1e-3).keywords == dict(lr=1e-3, initial_accumulator_value=0.1, eps=1e-7)
    with pytest.raises(NotImplementedError, match="queue A, 'Other config targets'"):
        optim.adam(1e-3, nesterov=True)
    with pytest.raises(NotImplementedError, match="queue A, 'Other config targets'"):
        instantiate({"_target_": "optax.sgd", "_partial_": True, "learning_rate": 1e-3})

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
