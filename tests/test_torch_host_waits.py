"""No step of training makes the host wait for the device (CPU, small model).

On the card, reading a device value on the host (`float(t)`, `.item()`) or
copying a host tensor to the card from pageable memory waits for every
kernel queued before it, so the host cannot run ahead of the device. JAX's
jitted step waits nowhere. These tests record the operators that one
`train_step` and one `Trainer.fit` batch dispatch outside the kernel
wrappers (whose plain twins run here; on the card they launch a kernel and
make no host op), and allow only the reads of host tensors that wait for
nothing: the sigma draw from the host generator. (The optimizers of
`train/optim.py` keep their step count as a Python int; under
`apply_if_finite` and `MultiSteps` as a device tensor, and the tree-wide
scalars of optax.contrib's rules stay device tensors. Every rule's step is
recorded alone below, and a train step with each kind of rule.)
"""

import dataclasses
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jamun_tpu_torch.models.e3conv as e3conv_mod
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.train import distributions as dist
from jamun_tpu_torch.train import loop, optim
from jamun_tpu_torch.train import optim_contrib as contrib
from jamun_tpu_torch.train import optim_transforms as transforms
from jamun_tpu_torch.train.optim import adam
from jamun_tpu_torch.train.state import create_train_state, make_train_step
from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger, make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04


class HostOps(TorchDispatchMode):
    """Records, outside the kernel wrappers: host reads of tensors that
    `allowed` does not name, copies of host-made tensors (`torch.tensor`)
    and fresh normal draws."""

    def __init__(self, allowed):
        super().__init__()
        self.allowed, self.depth = allowed, 0
        self.reads, self.copies, self.draws = [], [], []
        # host-made tensors by id, held so that no later tensor takes a freed one's id
        self.lifted = {}

    def muted(self, fn):
        def inner(*args, **kwargs):
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1

        return inner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self.depth == 0:
            if name == "_local_scalar_dense" and not self.allowed(args[0]):
                self.reads.append(tuple(args[0].shape))
            elif name == "lift_fresh":
                self.lifted[id(out)] = out
            elif name == "_to_copy" and id(args[0]) in self.lifted:
                self.copies.append(tuple(args[0].shape))
            elif name == "randn":
                self.draws.append(name)
        return out


class RecordedSigma:
    """A sigma distribution that remembers the tensors it drew."""

    def __init__(self, inner):
        self.inner, self.drawn = inner, []

    def sample(self, generator, shape=()):
        t = self.inner.sample(generator, shape)
        self.drawn.append(t)
        return t


def _model_and_batch():
    tb = make_test_batch(num_graphs=2, max_nodes=12, max_bonds=24, scale=0.35, device="cpu")
    arch = E3Conv(
        tensor_product="uvu", irreps_hidden="16x0e + 8x1e", n_layers=2, device="cpu", seed=0)
    # a mirror flip drawn at every step and one fixed noise draw: both were
    # host waits (`float(u) < rate`; the draw copied to the card per call)
    config = DenoiserConfig(1.0, 0.3, mirror_augmentation_rate=0.5, add_fixed_noise=True)
    return Denoiser(arch, config), tb


def _allowed(sigma: RecordedSigma):
    def allowed(t):
        return any(t is d for d in sigma.drawn)

    return allowed


def _mute_kernels(monkeypatch, rec: HostOps):
    for mod, name in ((e3conv_mod, "edge_features"), (k2, "fused_conv_block"), (k2, "conv_block_bwd")):
        monkeypatch.setattr(mod, name, rec.muted(getattr(mod, name)))


def test_train_step_makes_no_host_wait(monkeypatch):
    den, tb = _model_and_batch()
    sigma = RecordedSigma(dist.ConstantSigma(SIGMA))
    state = create_train_state(den, adam(1e-3), device="cpu")
    step = make_train_step(den, sigma)
    step(state, tb)  # makes the cached constants (fixed noise, rounded divisors)
    rec = HostOps(_allowed(sigma))
    _mute_kernels(monkeypatch, rec)
    with rec:
        _, aux = step(state, tb)
    assert torch.isfinite(aux["loss"])
    assert len(sigma.drawn) == 2
    assert rec.reads == [], f"host reads of device values: {rec.reads}"
    assert rec.copies == [], f"host tensors copied to the device: {rec.copies}"
    assert rec.draws == [], "the fixed noise was drawn again"


def test_mirror_flip_is_chosen_on_the_device():
    """The flip is `torch.where` on the draw: rate 1 always flips, a tiny
    rate never does, and the noise-free positions show it exactly."""
    den, tb = _model_and_batch()
    g = torch.Generator().manual_seed(0)
    for rate, sign in ((1.0, -1.0), (1e-9, 1.0)):
        den.config = dataclasses.replace(den.config, mirror_augmentation_rate=rate)
        y = den.add_noise(tb, 0.0, g)
        torch.testing.assert_close(y.pos, sign * tb.pos, rtol=0, atol=0)


def test_fit_moves_batches_without_a_wait(monkeypatch, tmp_path):
    """Every batch of `Trainer.fit` goes through `GraphBatch.to_device`, and
    one fit batch makes no host read of a device value."""
    den, tb = _model_and_batch()
    make_train_step(den, dist.ConstantSigma(SIGMA))(create_train_state(den, adam(1e-3), device="cpu"), tb)
    moved = []
    real_to_device = GraphBatch.to_device
    monkeypatch.setattr(
        GraphBatch, "to_device", lambda self, d: moved.append(str(d)) or real_to_device(self, d)
    )
    sigma = RecordedSigma(dist.ConstantSigma(SIGMA))
    trainer = loop.Trainer(
        loop.TrainerConfig(max_steps=1, log_every_n_steps=1000, checkpoint_dir=str(tmp_path / "ckpt")),
        RecordingLogger(), device="cpu",
    )
    rec = HostOps(_allowed(sigma))
    _mute_kernels(monkeypatch, rec)
    with rec:
        state = trainer.fit(den, adam(1e-3), sigma, FixedBatches([tb]))
    assert state.step == 1 and moved == ["cpu"]
    assert rec.reads == [] and rec.copies == [] and rec.draws == []


def test_to_device_pins_and_copies_without_blocking(monkeypatch):
    """A host batch bound for the card: each field pinned, then copied with
    `non_blocking=True` (checked here with the two tensor methods stubbed:
    this CPU build can neither pin nor reach a card)."""
    _, tb = _model_and_batch()
    calls = []
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: calls.append("pin") or self)
    monkeypatch.setattr(
        torch.Tensor, "to",
        lambda self, *a, **k: calls.append(("to", str(a[0]), k.get("non_blocking"))) or self,
    )
    out = tb.to_device("cuda")
    # every field that holds a tensor (this batch has no residue layout)
    n = sum(getattr(tb, f.name) is not None for f in dataclasses.fields(GraphBatch))
    assert calls == ["pin", ("to", "cuda", True)] * n
    assert isinstance(out, GraphBatch)
    calls.clear()
    tb.to_device("cpu")
    assert calls == [("to", "cpu", False)] * n


def test_fixed_noise_is_made_once():
    """`add_fixed_noise` draws its N(0, 1) positions once per (shape, device,
    dtype) and gives every call the same values, as before the cache."""
    den, tb = _model_and_batch()
    g = torch.Generator().manual_seed(0)
    den.config = dataclasses.replace(den.config, mirror_augmentation_rate=0.0)
    a = den.add_noise(tb, SIGMA, g).pos
    b = den.add_noise(tb, SIGMA, g).pos
    fixed = torch.randn(tb.pos.shape[1:], generator=torch.Generator().manual_seed(0))
    want = tb.pos + SIGMA * fixed[None] * tb.node_mask[..., None].float()
    torch.testing.assert_close(a, want, rtol=0, atol=0)
    torch.testing.assert_close(b, a, rtol=0, atol=0)


# every optimizer of `train/optim.py`, on E3Conv's parameters
_RULE_ARGS = {"adadelta": {}, "adafactor": {}, "rprop": {"learning_rate": 1e-3}}


def _kernels(tree):
    """A callable mask of the port's parameter tree: the leaves of 2 axes."""
    return {k: _kernels(v) if isinstance(v, dict) else v.ndim == 2 for k, v in tree.items()}


def _labels(tree):
    return {k: _labels(v) if isinstance(v, dict) else ("a" if v.ndim == 2 else "s")
            for k, v in tree.items()}


# the wrappers, combinators, optax.contrib's rules (the tree-wide scalars:
# prodigy, dadapt_adamw, cocob, dog, dowg, mechanize, schedule_free) and a
# few transforms alone
_WRAPPED = {
    "MultiSteps": lambda: optim.MultiSteps(optim.adam(1e-3), 2),
    "apply_if_finite": lambda: optim.apply_if_finite(
        optim.adam(optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10)), 2),
    "MultiSteps_skip_not_finite": lambda: optim.MultiSteps(
        optim.adam(1e-3), 2, should_skip_update_fn=optim.skip_not_finite),
    "MultiSteps_skip_large_updates": lambda: optim.MultiSteps(
        optim.adam(1e-3), 2, should_skip_update_fn=functools.partial(
            optim.skip_large_updates, max_squared_norm=1e6)),
    "MultiSteps_of_apply_if_finite": lambda: optim.MultiSteps(
        optim.apply_if_finite(optim.adam(1e-3), 2), 2),
    "apply_if_finite_of_prodigy": lambda: optim.apply_if_finite(contrib.prodigy(), 2),
    "masked": lambda: transforms.masked(optim.adamw(1e-3), _kernels),
    "multi_transform": lambda: transforms.multi_transform(
        {"a": optim.adamw(1e-3), "s": optim.sgd(1e-3, momentum=0.9)}, _labels),
    "flatten": lambda: transforms.flatten(optim.adam(1e-3)),
    "apply_every": lambda: transforms.apply_every(2),
    "clip_by_global_norm": lambda: transforms.clip_by_global_norm(1.0),
    "adaptive_grad_clip": lambda: transforms.adaptive_grad_clip(0.1),
    "scale_by_lbfgs": lambda: transforms.scale_by_lbfgs(4),
    "inject_hyperparams": lambda: transforms.inject_hyperparams(optim.adam)(
        learning_rate=optim.linear_schedule(1e-3, 1e-4, 10)),
    "acprop": lambda: contrib.acprop(1e-3),
    "ademamix": lambda: contrib.ademamix(1e-3),
    "simplified_ademamix": lambda: contrib.simplified_ademamix(1e-3),
    "adopt": lambda: contrib.adopt(1e-3),
    "cocob": contrib.cocob,
    "dadapt_adamw": contrib.dadapt_adamw,
    "dog": contrib.dog,
    "dog_learning_rate": lambda: contrib.dog(init_step=("learning_rate", 1e-3)),
    "dowg": contrib.dowg,
    "muon": lambda: contrib.muon(1e-3),
    "prodigy": contrib.prodigy,
    "schedule_free_adamw": lambda: contrib.schedule_free_adamw(1e-3, warmup_steps=4),
    "schedule_free_sgd": lambda: contrib.schedule_free_sgd(1e-3, weight_decay=1e-4),
    "normalize": contrib.normalize,
    "mechanize": lambda: contrib.mechanize(optim.adam(1e-3)),
    "schedule_free": lambda: contrib.schedule_free(optim.sgd(1e-3), 1e-3),
    "sam": lambda: contrib.sam(optim.sgd(1e-3), optim.sgd(1e-3)),
    "split_real_and_imaginary": lambda: contrib.split_real_and_imaginary(optim.adam(1e-3)),
}


def _factory(name: str):
    if name in _WRAPPED:
        return _WRAPPED[name]()
    return getattr(optim, name)(**_RULE_ARGS.get(name, {"learning_rate": 1e-3}))


@pytest.mark.parametrize("name", [*optim.RULES, *_WRAPPED])
def test_optimizer_steps_make_no_host_wait(name):
    """Each rule's step (and MultiSteps' and apply_if_finite's) after two
    warm-up steps reads no device value on the host and copies no host
    tensor: counts are Python ints, or device tensors under
    apply_if_finite, and every data-dependent choice (adafactor's
    clipping, rprop's signs, the trust ratios' zero-norm guards, a
    non-finite step) is `torch.where` on the device. sm3 refuses E3Conv's
    0-d output gain (as optax does), so it steps the other parameters."""
    den, _ = _model_and_batch()
    named = [(n, p) for n, p in den.arch.named_parameters()
             if not (name == "sm3" and p.ndim == 0)]
    opt = _factory(name)(named)
    g = torch.Generator().manual_seed(0)
    grads = [[torch.randn(p.shape, generator=g) for _, p in named] for _ in range(3)]
    for step in range(3):
        for (_, p), grad in zip(named, grads[step]):
            p.grad = grad
        if step < 2:
            opt.step()
            continue
        rec = HostOps(lambda t: False)
        with rec:
            opt.step()
    assert rec.reads == [], f"host reads of device values: {rec.reads}"
    assert rec.copies == [], f"host tensors copied to the device: {rec.copies}"
    assert all(torch.isfinite(p).all() for _, p in named)


@pytest.mark.parametrize("name", ["adafactor", "lamb", "apply_if_finite", "MultiSteps",
                                  "MultiSteps_skip_not_finite", "prodigy", "muon",
                                  "multi_transform"])
def test_train_step_with_each_kind_of_rule_makes_no_host_wait(monkeypatch, name):
    """A whole `train_step` with a leaf-wise rule and with each wrapper."""
    den, tb = _model_and_batch()
    sigma = RecordedSigma(dist.ConstantSigma(SIGMA))
    state = create_train_state(den, _factory(name), device="cpu")
    step = make_train_step(den, sigma)
    step(state, tb)
    step(state, tb)
    rec = HostOps(_allowed(sigma))
    _mute_kernels(monkeypatch, rec)
    with rec:
        _, aux = step(state, tb)
    assert torch.isfinite(aux["loss"])
    assert rec.reads == [] and rec.copies == [] and rec.draws == []
