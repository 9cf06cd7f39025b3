"""No step of training makes the host wait for the device (CPU, small model).

On the card, reading a device value on the host (`float(t)`, `.item()`) or
copying a host tensor to the card from pageable memory waits for every
kernel queued before it, so the host cannot run ahead of the device. JAX's
jitted step waits nowhere. These tests record the operators that one
`train_step` and one `Trainer.fit` batch dispatch outside the kernel
wrappers (whose plain twins run here; on the card they launch a kernel and
make no host op), and allow only the reads of host tensors that wait for
nothing: the sigma draw from the host generator. (The optimizers of
`train/optim.py` keep their step count as a Python int.)
"""

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jamun_tpu_torch.models.e3conv as e3conv_mod
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cuda import conv_block as k2
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.train import distributions as dist
from jamun_tpu_torch.train import loop
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
