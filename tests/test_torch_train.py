"""The port's training slice against JAX (CPU, f32): `kabsch_align`, the
denoiser's training loss and its gradients, three train steps (Adam, EMA),
the LR schedules and sigma distributions, the device rule and the Trainer.

The JAX side runs its XLA path (use_pallas=False); the port runs its kernel
path, which on the CPU goes through the plain twins of K1, K2 and K4 (the
backward of every ConvBlock is `conv_block_bwd_plain`). Both sides see the
same noise through `add_fixed_ones`. Parameters: JAX `Denoiser.init`, every
leaf perturbed with seeded numpy noise, so that no gradient is trivially 0.
Each tolerance is written beside its check.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.ops.geometry import kabsch_align as j_kabsch_align
from jamun_tpu.train import distributions as jdist
from jamun_tpu.train import lr_schedules as jlr
from jamun_tpu.train.state import TrainState as JTrainState, make_train_step as j_make_train_step
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.geometry import kabsch_align
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.train import distributions as dist
from jamun_tpu_torch.train import lr_schedules
from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
from jamun_tpu_torch.train.optim import adam
from jamun_tpu_torch.train.state import create_train_state, make_train_step
from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger, make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")


def _setup(seed=0, n_atoms=12):
    kw = dict(num_graphs=2, max_nodes=n_atoms, nodes_per_graph=[n_atoms, n_atoms - 2],
              max_bonds=2 * n_atoms, scale=0.35, seed=seed)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    jden = JDenoiser(JE3Conv(**ARCH, use_pallas=False), JConfig(1.0, 0.3, add_fixed_ones=True))
    params = jden.init(jax.random.PRNGKey(seed), jb)
    rng = np.random.default_rng(200 + seed)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )
    arch = E3Conv(**ARCH, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    return jden, params, jb, Denoiser(arch, DenoiserConfig(1.0, 0.3, add_fixed_ones=True)), tb


def _flat(tree) -> dict:
    """A flax tree (under "params") -> {dotted name: numpy array}."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path[1:]): np.asarray(v) for path, v in flat}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_kabsch_align_matches_jax():
    """Random pairs, a padded graph, and a mirrored copy (the reflection
    case: the best orthogonal map is a reflection, which the det fix turns
    into the best rotation). f32 SVD on both sides: 1e-5 absolute on O(1)
    coordinates."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 10, 3)).astype(np.float32)
    y = x @ np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    y = y + 0.1 * rng.standard_normal(y.shape).astype(np.float32)
    y[3] = x[3] * np.array([1.0, 1.0, -1.0], np.float32) + 0.05 * rng.standard_normal((10, 3))
    mask = np.ones((4, 10), bool)
    mask[1, 7:] = False
    x[1, 7:] = 0.0
    y[1, 7:] = 0.0
    got = kabsch_align(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(j_kabsch_align(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got[1, 7:] == 0.0)
    # the reflection was removed: the aligned mirror image is not x
    assert np.abs(got[3] - x[3]).max() > 0.1


def test_training_loss_and_grads_match_jax():
    """`training_loss` (kernel path, K4's twin as the backward) against JAX's
    `value_and_grad` of its XLA path. Loss and metrics: 1e-5 relative (f32
    summation order); gradients: 1e-4 of each leaf's max (sums over every
    pair and atom of the batch)."""
    jden, params, jb, den, tb = _setup()
    (jloss, jaux), jgrads = jax.value_and_grad(jden.training_loss, has_aux=True)(
        params, jax.random.PRNGKey(0), jb, SIGMA
    )
    loss, aux = den.training_loss(tb, SIGMA, torch.Generator())
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in ("coordinate_loss", "raw_coordinate_loss", "scaled_rmsd", "loss"):
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k
    want = _flat(jgrads)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in den.arch.named_parameters()}
    assert set(got) == set(want) and len(want) == 70
    live = [n for n, g in want.items() if np.abs(g).max() > 0]
    assert len(live) >= 66, sorted(set(want) - set(live))
    for name, ref in want.items():
        if name in live:
            assert _rel(got[name], ref) < 1e-4, (name, _rel(got[name], ref))
        else:  # a table the batch does not index (the residue-index embedding)
            assert np.abs(got[name]).max() == 0, name


def test_three_train_steps_match_jax():
    """Three steps of the port's `make_train_step` (Adam with optax's
    defaults, EMA 0.999) against JAX's with `optax.adam(1e-3)`. Loss and
    grad_norm: 1e-5 relative per step. Parameters and EMA after three
    steps: each step moves an entry by about lr = 1e-3 times m / sqrt(v),
    which f32 gradient differences change only in its last bits unless the
    entry's own gradient is near zero (measured: one entry of 800 of a
    rarely indexed embedding table off by 1.0e-5). So 2e-5 absolute (2% of
    one step) everywhere, and 2e-6 for 99% of the entries."""
    jden, params, jb, den, tb = _setup(seed=1)
    opt = optax.adam(1e-3)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=opt.init(params), ema_params=params, rng=jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(jden, opt, jdist.ConstantSigma(SIGMA), 0.999))
    state = create_train_state(den, adam(1e-3), seed=0, device="cpu")
    step = make_train_step(den, dist.ConstantSigma(SIGMA), 0.999)
    for _ in range(3):
        jstate, jaux = jstep(jstate, jb)
        state, aux = step(state, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(aux[k]) - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k
        assert float(aux["sigma"]) == float(jaux["sigma"])
    assert state.step == int(jstate.step) == 3
    for name, tree, module in (("params", jstate.params, state.module), ("ema", jstate.ema_params, state.ema)):
        want = _flat(tree)
        got = {n: p.detach().numpy() for n, p in module.named_parameters()}
        moved = _flat(params)
        for n, ref in want.items():
            np.testing.assert_allclose(got[n], ref, rtol=0, atol=2e-5, err_msg=f"{name} {n}")
        diff = np.concatenate([np.abs(got[n] - ref).ravel() for n, ref in want.items()])
        assert np.mean(diff <= 2e-6) > 0.99, (name, np.mean(diff <= 2e-6))
        # the step did move the weights (by about 3 lr for params, 3e-3 lr for the EMA)
        assert max(np.abs(want[n] - moved[n]).max() for n in want) > (2e-3 if name == "params" else 2e-6)


@pytest.mark.parametrize("name,args", [
    ("linear", (25,)),
    ("linear_warmup_linear_decay", (5, 30)),
    ("linear_warmup_plateau", (7,)),
])
def test_lr_schedules_exact(name, args):
    """The multipliers are computed in f32 as JAX computes them: equal bits."""
    fn, jfn = getattr(lr_schedules, name)(*args), getattr(jlr, name)(*args)
    for s in range(0, 40):
        assert fn(s) == float(jfn(s)), (name, s)
    lr = torch.optim.lr_scheduler.LambdaLR(torch.optim.SGD([torch.zeros(1)], lr=2.0), fn)
    assert lr.get_last_lr() == [2.0 * fn(0)]


def test_constant_sigma_exact():
    got = dist.ConstantSigma(0.04).sample(torch.Generator(), (3,))
    want = jdist.ConstantSigma(0.04).sample(jax.random.PRNGKey(0), (3,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and dist.ConstantSigma(0.04).mean == 0.04
    assert float(dist.ConstantSigma().sample(torch.Generator())) == np.float32(0.04)


def _moments(a):
    a = np.asarray(a, np.float64).reshape(-1)
    return a.mean(), a.std()


@pytest.mark.parametrize("make", [
    lambda m: m.UniformSigma(0.5, 0.1),
    lambda m: m.ExponentialSigma(50.0, 1e-2),
    lambda m: m.ClippedLogNormalSigma(math.log(0.05), 0.5, 0.1),
    lambda m: m.UniformPlusNormal(0.1, (2,)),
    lambda m: m.WeightedMeasurement(0.1, [1.0, 2.0, 1.0]),
    lambda m: m.UniformMeasurement(0.2, 4),
], ids=["uniform", "exponential", "clipped_lognormal", "uniform_plus_normal", "weighted", "uniform_measurement"])
def test_random_sigma_distributions(make):
    """The RNGs differ, so the port and JAX are held to the same support and
    the same mean and spread of log(sample) (or of the sample where it can
    be <= 0): within 6 standard errors of 20000 draws on each side."""
    n = 20000
    got = make(dist).sample(torch.Generator().manual_seed(0), (n,)).numpy()
    want = np.asarray(make(jdist).sample(jax.random.PRNGKey(0), (n,)))
    assert got.shape == want.shape and got.dtype == np.float32
    if isinstance(make(jdist), jdist.CategoricalValue):
        values = np.asarray(make(jdist).values, np.float32)
        np.testing.assert_array_equal(np.asarray(make(dist).values, np.float32), values)
        assert set(np.unique(got)) <= set(values)
        for v in values:
            assert abs((got == v).mean() - (want == v).mean()) < 0.02
        return
    lo, hi = min(want.min(), got.min()), max(want.max(), got.max())
    assert want.min() - 1e-6 <= got.min() and got.max() <= want.max() + 1e-6 or (lo, hi)
    f = np.log if want.min() > 0 else (lambda a: a)
    (m_g, s_g), (m_w, s_w) = _moments(f(got)), _moments(f(want))
    se = s_w / math.sqrt(n)
    assert abs(m_g - m_w) < 6 * math.sqrt(2) * se, (m_g, m_w)
    assert abs(s_g - s_w) < 6 * math.sqrt(2) * s_w / math.sqrt(2 * n) + 1e-9, (s_g, s_w)


def test_random_sigma_distributions_support():
    g = torch.Generator().manual_seed(1)
    assert dist.ClippedLogNormalSigma(0.0, 3.0, 2.0).sample(g, (1000,)).max() <= 2.0
    u = dist.UniformSigma(0.3, 0.2).sample(g, (1000,))
    assert u.min() >= 0.2 and u.max() <= 0.3
    e = dist.ExponentialSigma(5.0, 0.1).sample(g, (1000,))
    assert e.min() >= 0.1 and e.max() <= 5.0
    assert dist.UniformPlusNormal(0.1, (3, 2)).sample(g, (4,)).shape == (4, 3, 2)


def test_device_rule(tmp_path):
    """Train state and Trainer run on the card unless given device="cpu"."""
    _, _, _, den, tb = _setup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(den, adam(1e-3))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(TrainerConfig(checkpoint_dir=str(tmp_path / "ckpt")))
    state = create_train_state(den, adam(1e-3), device="cpu")
    assert state.generator.device.type == "cpu"
    assert next(state.module.parameters()).device.type == "cpu"
    assert next(state.ema.parameters()).device.type == "cpu"


def test_trainer_propagates_step_failure(monkeypatch, tmp_path):
    """No fallback: a failing step (here a kernel launch error raised inside
    the network's forward) leaves `fit` with that error."""
    _, _, _, den, tb = _setup()

    def boom(*args, **kwargs):
        raise RuntimeError("conv_block.conv_block_bf16 failed with CUDA error 700")

    before = {n: p.detach().clone() for n, p in den.arch.named_parameters()}
    monkeypatch.setattr(den.arch, "forward", boom)
    rec = RecordingLogger()
    trainer = Trainer(TrainerConfig(max_steps=3, checkpoint_dir=str(tmp_path / "ckpt")), rec, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        trainer.fit(den, adam(1e-3), dist.ConstantSigma(SIGMA), FixedBatches([tb] * 3))
    assert rec.metrics == []
    for n, p in den.arch.named_parameters():
        assert torch.equal(p, before[n]), n


def test_trainer_fit_logs_validates_and_checks_finite(tmp_path):
    """max_steps, log_every_n_steps and val_every_n_steps on the EMA weights
    (each validation saves a checkpoint); a schedule chained after Adam; a
    non-finite validation loss stops the run when check_finite is set."""
    _, _, _, den, tb = _setup()
    cfg = TrainerConfig(max_steps=4, log_every_n_steps=2, val_every_n_steps=2,
                        checkpoint_dir=str(tmp_path / "ckpt"), collect_sigma_diagnostics=False)
    schedule = lr_schedules.linear_warmup_linear_decay(2, 10)
    rec = RecordingLogger()
    state = Trainer(cfg, rec, device="cpu").fit(
        den, lambda p: adam(1e-3)(p, schedule=schedule), dist.ConstantSigma(SIGMA),
        FixedBatches([tb] * 10, [tb]),
    )
    assert state.step == 4
    assert state.optimizer.schedule is schedule and state.optimizer.param_groups[0]["count"] == 4
    # fit applies the schedule: one step from the same weights moves each
    # parameter by schedule(t) times the unscheduled Adam update (here 0.5;
    # the atol covers the rounding of p + update against a step of ~1e-3)
    shifted = lambda t: schedule(t + 1)  # noqa: E731
    deltas = {}
    for name, opt in (("plain", adam(1e-3)), ("scheduled", lambda p: adam(1e-3)(p, schedule=shifted))):
        den1 = _setup()[3]
        before = [p.detach().clone() for p in den1.arch.parameters()]
        one = TrainerConfig(max_steps=1, checkpoint_dir=str(tmp_path / name), collect_sigma_diagnostics=False)
        after = Trainer(one, RecordingLogger(), device="cpu").fit(
            den1, opt, dist.ConstantSigma(SIGMA), FixedBatches([tb], [tb])).module.parameters()
        deltas[name] = [a.detach() - b for a, b in zip(after, before)]
    assert max(float(d.abs().max()) for d in deltas["plain"]) > 5e-4
    for d_s, d_p in zip(deltas["scheduled"], deltas["plain"]):
        torch.testing.assert_close(d_s, shifted(0) * d_p, rtol=0, atol=2e-6)
    logged = [(s, sorted(k.split("/")[0] for k in m)[0]) for s, m in rec.metrics]
    assert logged == [(2, "epoch"), (2, "val"), (4, "epoch"), (4, "val")]
    for _, m in rec.metrics:
        assert all(math.isfinite(v) for v in m.values())
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "last.ckpt", "manifest.json", "step2.ckpt", "step4.ckpt"]
    # the EMA lags the trained weights
    assert any(
        not torch.equal(p, e) for p, e in zip(state.module.parameters(), state.ema.parameters())
    )

    with torch.no_grad():
        den.arch.output_gain.fill_(float("nan"))
    rec = RecordingLogger()
    cfg.checkpoint_dir = str(tmp_path / "ckpt_nan")
    state = Trainer(cfg, rec, device="cpu").fit(
        den, adam(1e-3), dist.ConstantSigma(SIGMA), FixedBatches([tb] * 10, [tb])
    )
    assert state.step == 2 and math.isnan(rec.metrics[-1][1]["val/loss"])
