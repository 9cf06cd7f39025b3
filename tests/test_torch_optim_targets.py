"""The last optax targets JAX's trainer can run, against optax 0.2.6 (CPU,
f32): optax.contrib's rules and wrappers, the combinators (`masked`,
`multi_transform` / `partition`, `freeze`, `selective_transform`,
`flatten`, `apply_every`, `conditionally_*`, `inject_hyperparams`, `chain`),
a wrapper inside a wrapper, MultiSteps' skip functions, and every transform
given alone as `model.optim`.

Each case is the YAML both CLIs take: JAX's `cmdline.common.build_optimizer`
and the port's build it from the same `model` config (`model.optim`, and
`model.lr_scheduler` chained after a bare transform, whose raw update
would otherwise move the parameters by O(1) a step), or, where optax takes
a Python function (a callable mask, `stateless`, `conditionally_*`), the
same function on both sides. The parameter tree has 2-d, 1-d, 0-d and 3-d
leaves under flax's "params"; every parameter is within 1e-6 of optax's
after every one of 20 steps (f32 rounding of the same operations on
parameters of order 1). The rules with tree-wide scalars (prodigy,
dadapt_adamw, cocob, dog, dowg, mechanize, schedule_free) sum their dot
products and norms in another order than XLA and still meet 1e-6 here.

Then: the classification of every public callable of `optax` and
`optax.contrib` (built by the port, refused by both, or not a target).
"""

import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.contrib
import pytest
import torch

from jamun_tpu.cmdline.common import build_optimizer as j_build_optimizer
from jamun_tpu_torch.cmdline.common import build_optimizer
from jamun_tpu_torch.config.instantiate import locate
from jamun_tpu_torch.train import optim, optim_transforms

# the module (its name is also the function's, which the package exports)
port_instantiate = importlib.import_module("jamun_tpu_torch.config.instantiate")

torch.set_num_threads(2)

TREE = {"Dense_0": {"kernel": (5, 3), "bias": (3,)}, "Dense_1": {"kernel": (3, 4)}, "gain": (),
        "stack": (4, 2, 3)}
NO_SCALAR = {"Dense_0": {"kernel": (5, 3), "bias": (3,)}, "stack": (4, 2, 3)}
MASK = {"params": {"Dense_0": True, "Dense_1": {"kernel": False}, "gain": False, "stack": True}}
LABELS = {"params": {"Dense_0": "a", "Dense_1": {"kernel": "s"}, "gain": "s", "stack": "a"}}
SCHED = {"_target_": "optax.constant_schedule", "value": 1e-2}


def _t(target: str, partial: bool = False, **kwargs) -> dict:
    """A config entry: `_target_`, `_partial_` and the arguments."""
    return {"_target_": target, **({"_partial_": True} if partial else {}), **kwargs}


ADAM = _t("optax.adam", learning_rate=2e-2)
ADAMW = _t("optax.adamw", learning_rate=2e-2, weight_decay=0.1)
SGD = _t("optax.sgd", learning_rate=5e-2, momentum=0.9)


def _opt(target: str, **kwargs) -> dict:
    """`model.optim`: a rule with `_partial_: true`, as the configs name it."""
    return _t(target, partial=True, **kwargs)


def _bare(target: str, **kwargs) -> dict:
    """A transform alone, with `model.lr_scheduler` chained after it."""
    return dict(optim=_opt(target, **kwargs), lr_scheduler=SCHED)


CASES = {
    # ---- optax.contrib's rules ----
    "acprop": dict(optim=_opt("optax.contrib.acprop", learning_rate=1e-2)),
    "acprop_decay": dict(optim=_opt("optax.contrib.acprop", learning_rate=1e-2, weight_decay=0.1,
                                    mask=MASK)),
    "ademamix": dict(optim=_opt("optax.contrib.ademamix", learning_rate=1e-2)),
    "ademamix_schedules": dict(optim=_opt(
        "optax.contrib.ademamix", learning_rate=1e-2,
        b3=_t("optax.linear_schedule", init_value=0.9, end_value=0.999, transition_steps=10),
        alpha=_t("optax.linear_schedule", init_value=0.0, end_value=5.0, transition_steps=10))),
    "simplified_ademamix": dict(optim=_opt("optax.contrib.simplified_ademamix",
                                           learning_rate=1e-3, alpha=2.0)),
    "adopt": dict(optim=_opt("optax.contrib.adopt", learning_rate=1e-2)),
    "adopt_nesterov_unclipped": dict(optim=_opt("optax.contrib.adopt", learning_rate=1e-2,
                                                nesterov=True, use_clipping=False)),
    "cocob": dict(optim=_opt("optax.contrib.cocob")),
    "cocob_decay": dict(optim=_opt("optax.contrib.cocob", learning_rate=0.5, weight_decay=1e-2,
                                   mask=MASK)),
    "dadapt_adamw": dict(optim=_opt("optax.contrib.dadapt_adamw", learning_rate=1.0,
                                    estim_lr0=1e-3, weight_decay=1e-2)),
    "dog": dict(optim=_opt("optax.contrib.dog")),
    "dog_learning_rate": dict(optim=_opt("optax.contrib.dog", init_step=["learning_rate", 1e-2],
                                         weight_decay=1e-3)),
    "dog_distance": dict(optim=_opt("optax.contrib.dog", init_step=["distance", 1e-2],
                                    learning_rate=0.5)),
    "dowg": dict(optim=_opt("optax.contrib.dowg")),
    "dowg_decay": dict(optim=_opt("optax.contrib.dowg", init_estim_sq_dist=1e-3,
                                  weight_decay=1e-3, mask=MASK)),
    "muon": dict(optim=_opt("optax.contrib.muon", learning_rate=1e-2)),
    "muon_adaptive": dict(optim=_opt("optax.contrib.muon", learning_rate=1e-2, adaptive=True,
                                     nesterov=False, weight_decay=1e-2, adam_weight_decay=1e-2,
                                     ns_steps=3)),
    "prodigy": dict(optim=_opt("optax.contrib.prodigy", estim_lr0=1e-3)),
    "prodigy_safeguard": dict(optim=_opt("optax.contrib.prodigy", estim_lr0=1e-3,
                                         safeguard_warmup=True, weight_decay=1e-2)),
    "schedule_free_adamw": dict(optim=_opt("optax.contrib.schedule_free_adamw",
                                           learning_rate=1e-2, warmup_steps=5,
                                           weight_decay=1e-2)),
    "schedule_free_sgd": dict(optim=_opt("optax.contrib.schedule_free_sgd", learning_rate=5e-2,
                                         weight_decay=1e-3)),
    "schedule_free_sgd_plain": dict(optim=_opt("optax.contrib.schedule_free_sgd",
                                               learning_rate=5e-2)),
    "normalize": _bare("optax.contrib.normalize"),
    # ---- optax.contrib's wrappers ----
    "mechanize": dict(optim=_opt("optax.contrib.mechanize", base_optimizer=ADAM)),
    "schedule_free": dict(optim=_opt("optax.contrib.schedule_free", base_optimizer=SGD,
                                     learning_rate=_t("optax.linear_schedule", init_value=1e-2,
                                                      end_value=1e-3, transition_steps=20))),
    "sam": dict(optim=_opt("optax.contrib.sam", optimizer=SGD,
                           adv_optimizer=_t("optax.sgd", learning_rate=1e-2))),
    "sam_period_3_kept": dict(optim=_opt("optax.contrib.sam", optimizer=ADAM,
                                         adv_optimizer=_t("optax.adam", learning_rate=1e-2),
                                         sync_period=3, reset_state=False)),
    "sam_reset_adam": dict(optim=_opt("optax.contrib.sam", optimizer=ADAM,
                                      adv_optimizer=_t("optax.adam", learning_rate=1e-2),
                                      sync_period=3)),
    "split_real_and_imaginary": dict(optim=_opt("optax.contrib.split_real_and_imaginary",
                                                inner=ADAM)),
    # ---- optax.contrib's transforms alone ----
    "scale_by_acprop": _bare("optax.contrib.scale_by_acprop"),
    "scale_by_ademamix": _bare("optax.contrib.scale_by_ademamix"),
    "scale_by_adopt": _bare("optax.contrib.scale_by_adopt"),
    "scale_by_cocob": _bare("optax.contrib.scale_by_cocob"),
    "scale_by_simplified_ademamix": _bare("optax.contrib.scale_by_simplified_ademamix"),
    # ---- combinators ----
    "masked": dict(optim=_opt("optax.masked", inner=ADAMW, mask=MASK)),
    "multi_transform": dict(optim=_opt("optax.multi_transform",
                                       transforms={"a": ADAMW, "s": SGD}, param_labels=LABELS)),
    "partition_leafwise": dict(optim=_opt(
        "optax.partition", param_labels=LABELS,
        transforms={"a": _t("optax.lamb", learning_rate=1e-2),
                    "s": _t("optax.adafactor", learning_rate=1e-2, min_dim_size_to_factor=2)})),
    "freeze": dict(_bare("optax.freeze", mask=MASK)),
    "selective_transform": dict(optim=_opt("optax.selective_transform", optimizer=ADAM,
                                           freeze_mask=MASK)),
    "flatten": dict(optim=_opt("optax.flatten", inner=ADAM)),
    "flatten_lamb": dict(optim=_opt("optax.flatten", inner=_t("optax.lamb", learning_rate=1e-2))),
    "with_extra_args_support": dict(optim=_opt("optax.with_extra_args_support", tx=ADAM)),
    "inject_hyperparams": dict(optim=_t("optax.inject_hyperparams", inner_factory=_opt(
        "optax.adam", learning_rate=_t("optax.linear_schedule", init_value=2e-2,
                                       end_value=1e-3, transition_steps=15)))),
    "inject_stateful_hyperparams": dict(optim=_t("optax.inject_stateful_hyperparams",
                                                 inner_factory=_opt("optax.lion",
                                                                    learning_rate=1e-3))),
    "apply_every": _bare("optax.apply_every", k=3),
    "snapshot": _bare("optax.snapshot", measure_name="norm",
                      measure=_t("optax.global_norm", partial=True)),
    # ---- wrappers inside wrappers, MultiSteps' skips ----
    "MultiSteps_skip_not_finite": dict(grads="nan_big", optim=_opt(
        "optax.MultiSteps", opt=ADAM, every_k_schedule=3,
        should_skip_update_fn=_t("optax.skip_not_finite", partial=True))),
    "MultiSteps_skip_large_updates_sum": dict(grads="nan_big", optim=_opt(
        "optax.MultiSteps", opt=ADAM, every_k_schedule=2, use_grad_mean=False,
        should_skip_update_fn=_t("optax.skip_large_updates", partial=True,
                                 max_squared_norm=400.0))),
    "MultiSteps_of_apply_if_finite": dict(grads="nan_big", optim=_opt(
        "optax.MultiSteps", every_k_schedule=2,
        opt=_t("optax.apply_if_finite", inner=ADAM, max_consecutive_errors=2))),
    "apply_if_finite_of_MultiSteps": dict(grads="nan_big", optim=_opt(
        "optax.apply_if_finite", max_consecutive_errors=3,
        inner=_t("optax.MultiSteps", opt=ADAM, every_k_schedule=3))),
    "MultiSteps_of_masked": dict(optim=_opt(
        "optax.MultiSteps", every_k_schedule=2, opt=_t("optax.masked", inner=ADAMW, mask=MASK))),
    "apply_if_finite_of_multi_transform": dict(grads="nan_big", optim=_opt(
        "optax.apply_if_finite", max_consecutive_errors=1,
        inner=_t("optax.multi_transform", transforms={"a": ADAMW, "s": SGD},
                 param_labels=LABELS))),
    "MultiSteps_skip_of_mechanize": dict(grads="nan_big", optim=_opt(
        "optax.MultiSteps", every_k_schedule=2,
        should_skip_update_fn=_t("optax.skip_not_finite", partial=True),
        opt=_t("optax.contrib.mechanize", base_optimizer=ADAM))),
    "apply_if_finite_of_prodigy": dict(grads="nan_big", optim=_opt(
        "optax.apply_if_finite", max_consecutive_errors=2,
        inner=_t("optax.contrib.prodigy", estim_lr0=1e-3))),
    # ---- optax's transforms alone ----
    "scale": _bare("optax.scale", step_size=-0.5),
    "scale_by_adam": _bare("optax.scale_by_adam", nesterov=True),
    "scale_by_adadelta": _bare("optax.scale_by_adadelta"),
    "scale_by_adamax": _bare("optax.scale_by_adamax"),
    "scale_by_adan": _bare("optax.scale_by_adan"),
    "scale_by_amsgrad": _bare("optax.scale_by_amsgrad"),
    "scale_by_belief": _bare("optax.scale_by_belief"),
    # optax 0.2.6 divides by the root of the update itself: NaN where it is negative
    "scale_by_distance_over_gradients": dict(_bare("optax.scale_by_distance_over_gradients"),
                                             nan=True),
    "scale_by_factored_rms": _bare("optax.scale_by_factored_rms", min_dim_size_to_factor=2),
    # its memory pairs are differences of nearly equal f32 parameters, so the
    # last-bit differences of two implementations grow step by step
    "scale_by_lbfgs": dict(optim=_opt("optax.scale_by_lbfgs", memory_size=4), grads="quadratic",
                           lr_scheduler=_t("optax.constant_schedule", value=0.1), tol=1e-4),
    "scale_by_learning_rate": _bare("optax.scale_by_learning_rate", learning_rate=0.5),
    "scale_by_learning_rate_schedule": dict(optim=_opt(
        "optax.scale_by_learning_rate", learning_rate=_t(
            "optax.cosine_decay_schedule", init_value=2e-2, decay_steps=20))),
    "scale_by_lion": _bare("optax.scale_by_lion"),
    "scale_by_novograd": _bare("optax.scale_by_novograd"),
    "scale_by_optimistic_gradient": _bare("optax.scale_by_optimistic_gradient"),
    "scale_by_param_block_norm": _bare("optax.scale_by_param_block_norm"),
    "scale_by_param_block_rms": _bare("optax.scale_by_param_block_rms"),
    "scale_by_radam": _bare("optax.scale_by_radam"),
    "scale_by_rms": _bare("optax.scale_by_rms"),
    "scale_by_rms_corrected": _bare("optax.scale_by_rms", bias_correction=True,
                                    eps_in_sqrt=False, initial_scale=0.5),
    "scale_by_rprop": _bare("optax.scale_by_rprop", learning_rate=0.1),
    "scale_by_rss": _bare("optax.scale_by_rss"),
    "scale_by_schedule": dict(optim=_opt("optax.scale_by_schedule", step_size_fn=_t(
        "optax.linear_schedule", init_value=-2e-2, end_value=-1e-3, transition_steps=15))),
    "scale_by_sign": _bare("optax.scale_by_sign"),
    "scale_by_sm3": dict(_bare("optax.scale_by_sm3"), shapes=NO_SCALAR),
    "scale_by_stddev": _bare("optax.scale_by_stddev"),
    "scale_by_stddev_corrected": _bare("optax.scale_by_stddev", bias_correction=True,
                                       eps_in_sqrt=False, initial_scale=2.0),
    "scale_by_trust_ratio": _bare("optax.scale_by_trust_ratio", min_norm=1e-3),
    "scale_by_yogi": _bare("optax.scale_by_yogi"),
    "add_decayed_weights": _bare("optax.add_decayed_weights", weight_decay=0.5, mask=MASK),
    "adaptive_grad_clip": _bare("optax.adaptive_grad_clip", clipping=0.1),
    "centralize": _bare("optax.centralize"),
    "clip": _bare("optax.clip", max_delta=0.5),
    "clip_by_block_rms": _bare("optax.clip_by_block_rms", threshold=0.5),
    "clip_by_global_norm": _bare("optax.clip_by_global_norm", max_norm=3.0),
    "ema": _bare("optax.ema", decay=0.8),
    "ema_biased_bf16": _bare("optax.ema", decay=0.8, debias=False, accumulator_dtype="bfloat16"),
    "identity": _bare("optax.identity"),
    "keep_params_nonnegative": _bare("optax.keep_params_nonnegative"),
    "normalize_by_update_norm": _bare("optax.normalize_by_update_norm", scale_factor=2.0),
    "set_to_zero": _bare("optax.set_to_zero"),
    "trace": _bare("optax.trace", decay=0.9, nesterov=True),
    "trace_bf16": _bare("optax.trace", decay=0.9, accumulator_dtype="bfloat16"),
    "zero_nans": dict(_bare("optax.zero_nans"), grads="nan_big"),
}


def _ndim_mask(side: str):
    """A callable mask (kernels and the 3-d leaf) on either side's tree."""
    if side == "jax":
        return lambda tree: jax.tree.map(lambda p: p.ndim >= 2, tree)

    def mask(tree):
        def walk(node):
            return {k: walk(v) if isinstance(v, dict) else v.ndim >= 2 for k, v in node.items()}
        return walk(tree)
    return mask


def _every_third(step):
    return step % 3 != 1


# cases with Python functions: (optax's rule, the port's factory), no schedule
BUILT = {
    "masked_callable": (lambda: optax.masked(optax.adam(2e-2), _ndim_mask("jax")),
                        lambda: optim_transforms.masked(optim.adam(2e-2), _ndim_mask("port"))),
    "conditionally_transform": (
        lambda: optax.conditionally_transform(optax.adam(2e-2), _every_third),
        lambda: optim_transforms.conditionally_transform(optim.adam(2e-2), _every_third)),
    "conditionally_mask": (
        lambda: optax.conditionally_mask(optax.sgd(5e-2, momentum=0.9), _every_third),
        lambda: optim_transforms.conditionally_mask(optim.sgd(5e-2, momentum=0.9),
                                                    _every_third)),
    "stateless": (
        lambda: optax.stateless(
            lambda u, p: jax.tree.map(lambda a, b: -1e-2 * a - 1e-3 * b, u, p)),
        lambda: optim_transforms.stateless(
            lambda u, p: {"params": _map2(lambda a, b: -1e-2 * a - 1e-3 * b, u["params"],
                                          p["params"])})),
    "stateless_with_tree_map": (
        lambda: optax.stateless_with_tree_map(lambda g, p: -1e-2 * g * (1 + p.ndim)),
        lambda: optim_transforms.stateless_with_tree_map(lambda g, p: -1e-2 * g * (1 + p.ndim))),
}


def _map2(fn, a: dict, b: dict) -> dict:
    return {k: _map2(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k]) for k, v in a.items()}


def _flat(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _unflat(names_values) -> dict:
    out: dict = {}
    for name, v in names_values:
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _stream(kind: str, shapes: dict, n: int, rng):
    """The gradients of `n` steps (flat name -> array); "nan_big" puts a NaN
    in Dense_0.kernel at step 4 and multiplies step 9 by 1e3."""
    names = [n for n, _ in _flat(shapes)]
    out = [{name: rng.standard_normal(s).astype(np.float32) for name, s in _flat(shapes)}
           for _ in range(n)]
    if kind == "nan_big":
        out[4]["Dense_0.kernel"][1, 1] = np.nan
        if n > 9:
            out[9] = {k: v * 1e3 for k, v in out[9].items()}
    assert set(names) == set(out[0])
    return out


def _sides(case: str):
    """(optax's rule, the port's factory) of a case."""
    if case in BUILT:
        jrule, prule = BUILT[case]
        return jrule(), prule()
    spec = CASES[case]
    model = {k: spec[k] for k in ("optim", "lr_scheduler") if k in spec}
    return j_build_optimizer(model), build_optimizer(model)


def _walk(case: str, steps: int = 20, seed: int = 3, sides=None):
    """optax and the port on the same gradients for `steps` steps; returns
    the largest difference of any parameter after any step, the port's
    optimizer and its parameters."""
    spec = CASES.get(case, {})
    shapes = spec.get("shapes", TREE)
    rng = np.random.default_rng(seed)
    init = {name: rng.standard_normal(s).astype(np.float32) for name, s in _flat(shapes)}
    tx, factory = sides or _sides(case)
    jparams = {"params": jax.tree.map(jnp.asarray, _unflat(init.items()))}
    jstate = tx.init(jparams)
    params = {name: torch.nn.Parameter(torch.from_numpy(v.copy())) for name, v in init.items()}
    opt = factory(list(params.items()))
    target = {name: rng.standard_normal(v.shape).astype(np.float32) for name, v in init.items()}
    curvature = {name: rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                 for name, v in init.items()}
    grads = _stream(spec.get("grads", "normal"), shapes, steps, rng)
    err = 0.0
    for i, g in enumerate(grads):
        if spec.get("grads") == "quadratic":
            cur = dict(_flat(jparams["params"]))
            g = {k: curvature[k] * (target[k] - np.asarray(cur[k])) for k in g}
        jg = {"params": jax.tree.map(jnp.asarray, _unflat(g.items()))}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(np.array(g[k]))
        opt.step()
        want = dict(_flat(jparams["params"]))
        for k, p in params.items():
            # scale_by_distance_over_gradients turns a 0-d leaf into shape (1,) in optax
            got, ref = p.detach().numpy().reshape(np.shape(want[k])), np.asarray(want[k])
            np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=f"{case} {i} {k}")
            keep = ~np.isnan(ref)
            scale = max(1.0, float(np.abs(ref[keep]).max(initial=0.0)))
            err = max(err, float(np.abs(got[keep] - ref[keep]).max(initial=0.0)) / scale)
    return err, opt, params


@pytest.mark.parametrize("case", sorted([*CASES, *BUILT]))
def test_target_matches_optax_for_twenty_steps(case):
    """Every parameter within 1e-6 of max(1, the leaf's largest magnitude)
    of optax's after every step (the scale: a ×1e3 gradient step can push a
    leaf well past 1, where f32's own resolution passes 1e-6). lbfgs: 1e-4
    (`test_lbfgs_matches_optax_in_f64` holds the algorithm to 1e-10)."""
    err, opt, params = _walk(case)
    assert err <= CASES.get(case, {}).get("tol", 1e-6), (case, err)
    spec = CASES.get(case, {})
    if spec.get("grads") != "nan_big" and not spec.get("nan"):
        assert all(torch.isfinite(p).all() for p in params.values()), case


def _module(values: dict, shapes: dict) -> torch.nn.Module:
    """A module whose parameters carry the flax names of `values` (name ->
    array), each in the port's shape."""
    root = torch.nn.Module()
    for name, v in values.items():
        *path, leaf = name.split(".")
        node = root
        for k in path:
            if not hasattr(node, k):
                setattr(node, k, torch.nn.Module())
            node = getattr(node, k)
        shape = dict(_flat(shapes))[name]
        setattr(node, leaf, torch.nn.Parameter(torch.from_numpy(
            np.array(v, dtype=np.float32).reshape(shape))))
    return root


@pytest.mark.parametrize("case", sorted([*CASES, *BUILT]))
def test_target_resumes_from_a_jax_state_after_seven_steps(case, tmp_path):
    """optax's state after 7 steps (with `model.lr_scheduler` chained where
    the case has one), written by flax (a leaf `masked` leaves out as an
    empty map), read by the port's reader and placed by the rule's declared
    layout (`params._load_jax_opt_state`) into a fresh optimizer bound to a
    module of the same flax names; the 8th step on the same gradient gives
    optax's parameters within 1e-6 of max(1, each leaf's largest
    magnitude) (lbfgs: its 1e-4)."""
    import flax.serialization

    from jamun_tpu_torch.params import _load_jax_opt_state
    from jamun_tpu_torch.train.checkpoints import read_flax_msgpack

    spec = CASES.get(case, {})
    shapes = spec.get("shapes", TREE)
    rng = np.random.default_rng(5)
    init = {name: rng.standard_normal(s).astype(np.float32) for name, s in _flat(shapes)}
    target = {name: rng.standard_normal(v.shape).astype(np.float32) for name, v in init.items()}
    curvature = {name: rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                 for name, v in init.items()}
    grads = _stream(spec.get("grads", "normal"), shapes, 8, rng)
    tx, factory = _sides(case)
    jparams = {"params": jax.tree.map(jnp.asarray, _unflat(init.items()))}
    jstate = tx.init(jparams)

    def gradient(i):
        if spec.get("grads") != "quadratic":
            return grads[i]
        cur = dict(_flat(jparams["params"]))
        return {k: curvature[k] * (target[k] - np.asarray(cur[k])) for k in grads[i]}

    for i in range(7):
        jg = {"params": jax.tree.map(jnp.asarray, _unflat(gradient(i).items()))}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    path = tmp_path / "opt_state.msgpack"
    path.write_bytes(flax.serialization.to_bytes(jstate))
    module = _module(dict(_flat(jparams["params"])), shapes)
    opt = optim.bind(factory, module)
    _load_jax_opt_state(read_flax_msgpack(str(path)), module, opt, 7)
    g = gradient(7)
    updates, _ = tx.update({"params": jax.tree.map(jnp.asarray, _unflat(g.items()))}, jstate,
                           jparams)
    want = dict(_flat(optax.apply_updates(jparams, updates)["params"]))
    for name, p in module.named_parameters():
        p.grad = torch.from_numpy(np.array(g[name], dtype=np.float32).reshape(p.shape))
    opt.step()
    for name, p in module.named_parameters():
        got, ref = p.detach().numpy().reshape(np.shape(want[name])), np.asarray(want[name])
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=f"{case} {name}")
        keep = ~np.isnan(ref)
        scale = max(1.0, float(np.abs(ref[keep]).max(initial=0.0)))
        err = float(np.abs(got[keep] - ref[keep]).max(initial=0.0)) / scale
        assert err <= spec.get("tol", 1e-6), (case, name, err)


def test_lbfgs_matches_optax_in_f64():
    """scale_by_lbfgs (memory 4, scaled by 0.5) in f64 on both sides over
    20 steps of a quadratic: within 1e-10, so the f32 case's wider
    tolerance is rounding that its memory amplifies, not another algorithm."""
    rng = np.random.default_rng(0)
    shapes = dict(_flat(TREE))
    init = {k: np.asarray(rng.standard_normal(s)) for k, s in shapes.items()}
    target = {k: np.asarray(rng.standard_normal(s)) for k, s in shapes.items()}
    with jax.enable_x64(True):
        tx = optax.chain(optax.scale_by_lbfgs(memory_size=4), optax.scale(0.5))
        jp = {k: jnp.asarray(v) for k, v in init.items()}
        js = tx.init(jp)
        params = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in init.items()]
        opt = functools.partial(optim_transforms.scale_by_lbfgs(memory_size=4),
                                schedule=lambda count: 0.5)(params)
        for _ in range(20):
            g = {k: np.asarray(target[k] - np.asarray(jp[k])) for k in shapes}
            u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, u)
            for k, p in params:
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
            err = max(float(np.abs(p.detach().numpy() - np.asarray(jp[k])).max())
                      for k, p in params)
            assert err <= 1e-10, err


def test_masked_leaf_takes_the_raw_gradient():
    """optax's quirk, kept: a leaf `masked` leaves out takes the incoming
    update itself, so as `model.optim` alone it ascends the gradient."""
    _, factory = _sides("masked")
    p = {"Dense_1.kernel": torch.nn.Parameter(torch.zeros(3, 4)),
         "Dense_0.kernel": torch.nn.Parameter(torch.zeros(5, 3))}
    opt = factory(list(p.items()))
    for t in p.values():
        t.grad = torch.ones_like(t)
    opt.step()
    assert torch.equal(p["Dense_1.kernel"], torch.ones(3, 4))  # left out: p + g
    assert float(p["Dense_0.kernel"].max()) < 0  # adamw descends


def test_add_noise_on_injected_noise(monkeypatch):
    """add_noise alone (with the chained schedule) against optax's on the
    same noise, drawn here and given to both sides."""
    import optax.tree

    rng = np.random.default_rng(11)
    noise = [{k: rng.standard_normal(s).astype(np.float32) for k, s in _flat(TREE)}
             for _ in range(20)]
    draws = iter(noise)
    monkeypatch.setattr(optax.tree, "random_like", lambda key, target_tree, sampler: {
        "params": jax.tree.map(jnp.asarray, _unflat(next(draws).items()))})
    model = _bare("optax.add_noise", eta=0.3, gamma=0.55, key=0)
    tx, factory = j_build_optimizer(model), build_optimizer(model)

    def ported(named):
        opt = factory(named)
        draws = iter(noise)
        opt.steps[0].noise = lambda rule, updates: [
            torch.from_numpy(d[n].copy()) for d in [next(draws)] for n in rule.names]
        return opt

    err, _, _ = _walk("add_noise", sides=(tx, ported))
    assert err <= 1e-6, err


# ---- the classification of every public callable of optax and optax.contrib ----

# (c): not a transformation a config gives as `model.optim`: losses, tree and
# numerics utilities, schedules' types, state and protocol classes
NOT_TARGETS = {
    "optax": {
        # losses
        "convex_kl_divergence", "cosine_distance", "cosine_similarity", "ctc_loss",
        "ctc_loss_with_forward_probs", "hinge_loss", "huber_loss", "kl_divergence", "l2_loss",
        "log_cosh", "ntxent", "safe_softmax_cross_entropy", "sigmoid_binary_cross_entropy",
        "sigmoid_focal_loss", "smooth_labels", "softmax_cross_entropy",
        "softmax_cross_entropy_with_integer_labels", "squared_error",
        # utilities on trees, arrays and updates
        "apply_updates", "bias_correction", "incremental_update", "init_empty_state",
        "matrix_inverse_pth_root", "multi_normal", "nnls", "per_example_global_norm_clip",
        "per_example_layer_norm_clip", "periodic_update", "power_iteration", "safe_increment",
        "safe_int32_increment", "safe_norm", "safe_root_mean_squares", "scale_gradient",
        "tree_map_params", "update_infinity_moment", "update_moment",
        "update_moment_per_elem_norm", "value_and_grad_from_state",
        # types, protocols and state classes
        "GradientTransformation", "GradientTransformationExtraArgs", "MaskOrFn", "MaskedNode",
        "OptState", "Params", "Schedule", "ScalarOrSchedule", "ShouldSkipUpdateFunction",
        "TransformInitFn", "TransformUpdateExtraArgsFn", "TransformUpdateFn", "Updates",
        "WrappedSchedule", "LookaheadParams", "ZoomLinesearchInfo",
    },
    "optax.contrib": {"schedule_free_eval_params", "MuonDimensionNumbers"},
}
# (a) helpers a config hands to a target, not a rule themselves: built by the
# port and held to optax inside the cases that take them
ARGUMENTS = {"optax.skip_not_finite": "MultiSteps_skip_not_finite",
             "optax.skip_large_updates": "MultiSteps_skip_large_updates_sum",
             "optax.global_norm": "snapshot"}


def _public(module) -> list:
    return sorted(n for n in dir(module) if not n.startswith("_") and callable(getattr(module, n)))


def _is_state_class(obj) -> bool:
    return inspect.isclass(obj) and (obj.__name__.endswith("State") or issubclass(obj, tuple))


def _targets_in_cases() -> set:
    """Every `_target_` the cases above (and the earlier optimizer tests'
    rules, schedules and wrappers) build through the port's resolver."""
    seen = set()

    def walk(node):
        if isinstance(node, dict):
            if "_target_" in node:
                seen.add(node["_target_"])
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(CASES)
    seen |= {f"optax.{n}" for n in (*optim.RULES, *optim.SCHEDULES, *optim.WRAPPERS)}
    seen |= {"optax.stateless", "optax.stateless_with_tree_map", "optax.conditionally_transform",
             "optax.conditionally_mask", "optax.add_noise"}
    return seen


def test_every_public_callable_of_optax_is_classified():
    """Each public callable of optax and optax.contrib is (a) built by the
    port and held to optax by a case of this file or of the earlier
    optimizer tests, (b) refused by JAX's trainer and by the port under a
    shared title (`test_targets_jax_cannot_run_fail_on_both_sides`), or (c)
    not a transformation target. Nothing is left over, nothing is in two
    classes."""
    covered = _targets_in_cases()
    refused = port_instantiate._REFUSED
    for module in (optax, optax.contrib):
        for name in _public(module):
            path = f"{module.__name__}.{name}"
            obj = getattr(module, name)
            classes = [path in port_instantiate._OPTAX and path not in refused, path in refused,
                       name in NOT_TARGETS[module.__name__] or _is_state_class(obj)]
            assert sum(classes) == 1, (path, classes)
            if classes[0]:
                assert path in covered or path in ARGUMENTS, f"{path}: no case holds it to optax"
                assert callable(locate(path)), path
    assert {n.rpartition(".")[0] for n in port_instantiate._OPTAX} == {"optax", "optax.contrib"}


# (b): each refused target with the arguments a config gives it
REFUSED = {
    "optax.lbfgs": {}, "optax.polyak_sgd": {}, "optax.scale_by_polyak": {},
    "optax.scale_by_backtracking_linesearch": {"max_backtracking_steps": 5},
    "optax.scale_by_zoom_linesearch": {"max_linesearch_steps": 5},
    "optax.contrib.momo": {}, "optax.contrib.momo_adam": {}, "optax.contrib.reduce_on_plateau": {},
    "optax.contrib.sophia": {"learning_rate": 1e-3},
    "optax.contrib.hutchinson_estimator_diag_hessian": {},
    "optax.contrib.dpsgd": {"learning_rate": 1e-3, "l2_norm_clip": 1.0, "noise_multiplier": 1.0,
                            "seed": 0},
    "optax.contrib.differentially_private_aggregate": {"l2_norm_clip": 1.0,
                                                       "noise_multiplier": 1.0, "key": 0},
    "optax.lookahead": {"fast_optimizer": ADAM, "sync_period": 2, "slow_step_size": 0.5},
    # by position only: a config's keywords reach neither, and an empty chain fails
    "optax.chain": {"transforms": [ADAM]}, "optax.named_chain": {"transforms": [["a", ADAM]]},
    # without dimension numbers its update maps over None; with them every
    # leaf must have two axes, and every model of the repo has 0-d and 1-d ones
    "optax.contrib.scale_by_muon": {},
}
TITLES = {"Rules that need the loss", "Rules that need per-example gradients",
          "Targets JAX's trainer cannot run"}


@pytest.mark.parametrize("target", sorted(REFUSED))
def test_targets_jax_cannot_run_fail_on_both_sides(target):
    """JAX's trainer (`build_optimizer`, `init`, then `update(grads,
    state, params)` under jit, as `make_train_step` calls it) fails on the
    target; the port's resolver raises NotImplementedError naming the title
    the item shares with the reference."""
    assert set(REFUSED) == set(port_instantiate._REFUSED)
    model = {"optim": _opt(target, **REFUSED[target])}
    params = {"params": {"w": jnp.ones((3, 2)), "b": jnp.ones(2)}}
    with pytest.raises((TypeError, ValueError, AttributeError)):
        tx = j_build_optimizer(model)
        jax.jit(tx.update)(jax.tree.map(lambda x: 0.1 * x, params), tx.init(params), params)
    title = port_instantiate._REFUSED[target]
    assert title in TITLES
    with pytest.raises(NotImplementedError, match=f"queue A, '{title}'"):
        build_optimizer(model)
