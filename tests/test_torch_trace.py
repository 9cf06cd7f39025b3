"""The port's spans (`utils/trace.py`) on the CPU: with no profiler
recording `span` is one shared null context and the walk and the training
step dispatch the same operators with and without their spans; under
`torch.profiler` a walk, a training step, each regime of `E3Conv.forward`
and a kernel launch emit their `jamun.` spans, nested and in order; no
module of the port reaches `record_function` but through `span`."""

import json
import re
import sys
import types
from contextlib import nullcontext
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.ops.cuda.build import CudaKernel
from jamun_tpu_torch.parallel import atom_sharded, mesh
from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
from jamun_tpu_torch.sampling.sampler import Sampler
from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
from jamun_tpu_torch.train import distributions as dist
from jamun_tpu_torch.train import loop
from jamun_tpu_torch.train.optim import adam
from jamun_tpu_torch.train.state import create_train_state, make_train_step
from jamun_tpu_torch.utils import trace
from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger, make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=1, tensor_product="uvu", device="cpu", seed=0)
PKG = Path(__file__).resolve().parents[1] / "jamun_tpu_torch"


class Ops(TorchDispatchMode):
    """The names of the operators dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _span_users():
    """Every loaded module of the port that calls `span`."""
    return [m for name, m in sorted(sys.modules.items())
            if name.startswith("jamun_tpu_torch.") and getattr(m, "span", None) is trace.span]


def _denoiser(**kw):
    arch = E3Conv(**ARCH, **kw).requires_grad_(False)
    return Denoiser(arch, DenoiserConfig(1.0, 0.5))


def _walk(den, tb, steps=3):
    sampler = SingleMeasurementSampler(BAOAB(MCMCConfig(steps=steps)), SIGMA)
    return Sampler(device="cpu").sample(den, sampler, 1, tb, seed=5)


def _fit(tmp_path, log_every=1):
    den = Denoiser(E3Conv(**ARCH), DenoiserConfig(1.0, 0.5))
    tb = make_test_batch(num_graphs=2, max_nodes=8, max_bonds=16, scale=0.35, device="cpu")
    trainer = loop.Trainer(
        loop.TrainerConfig(max_steps=1, log_every_n_steps=log_every, checkpoint_dir=str(tmp_path / "ckpt"),
                           collect_sigma_diagnostics=False),
        RecordingLogger(), device="cpu",
    )
    return lambda: trainer.fit(den, adam(1e-3), dist.ConstantSigma(SIGMA), FixedBatches([tb]))


def _spans(fn, tmp_path):
    """The `jamun.` spans `fn()` emits under the profiler: [name, start, end]
    in order of start, the outer first among equal starts."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [[e["name"], e["ts"], e["ts"] + e["dur"]] for e in events
           if e.get("cat") == "user_annotation" and e["name"].startswith("jamun.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _children(spans, parent):
    """The spans directly inside `parent` (inside it, inside no other span inside it)."""
    inside = [s for s in spans if s is not parent and parent[1] <= s[1] and s[2] <= parent[2]]
    return [s for s in inside if not any(o is not s and o[1] <= s[1] and s[2] <= o[2] for o in inside)]


def test_without_a_profiler_span_is_one_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("jamun.walk.step"), trace.span("jamun.kernel:e3_stack")
    assert a is b and isinstance(a, nullcontext)
    rec = Ops()
    with rec:
        with a, b:
            pass
    assert rec.names == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("jamun.walk.step") is not a


@pytest.mark.parametrize("what", ["sample", "train_step"])
def test_spans_dispatch_no_operator_without_a_profiler(what, monkeypatch):
    """The operators of a 3-step `Sampler.sample` (or one `train_step`) are
    the same with the spans and with every span taken out; a span that
    entered `record_function` would show as the profiler's own operators."""
    tb = make_test_batch(num_graphs=2, max_nodes=8, max_bonds=16, scale=0.35, device="cpu")
    if what == "sample":
        den = _denoiser(plain=True)
        run = lambda: _walk(den, tb)  # noqa: E731
    else:
        den = Denoiser(E3Conv(**ARCH), DenoiserConfig(1.0, 0.5))
        state = create_train_state(den, adam(1e-3), device="cpu")
        step = make_train_step(den, dist.ConstantSigma(SIGMA))
        run = lambda: step(state, tb)  # noqa: E731
    run()  # caches

    def record():
        rec = Ops()
        with rec:
            run()
        return rec.names

    with_spans = record()
    users = _span_users()
    assert {m.__name__.rsplit(".", 1)[1] for m in users} >= {"mcmc", "walkjump", "sampler", "denoiser", "e3conv",
                                                             "build", "state", "loop"}
    for m in users:
        monkeypatch.setattr(m, "span", lambda name: nullcontext())
    assert record() == with_spans
    for m in users:
        monkeypatch.setattr(m, "span", torch.profiler.record_function)
    assert "profiler._record_function_enter_new.default" in record()


def test_a_walk_emits_its_spans(tmp_path):
    """A k-step `Sampler.sample` on the plain path: the graph mask's read,
    one batch holding the walk's start, k - 1 steps each holding exactly one
    score > xhat > forward, the jump, then the unbatching with its copies."""
    k = 4
    tb = make_test_batch(num_graphs=2, max_nodes=8, max_bonds=16, scale=0.35, device="cpu")
    spans = _spans(lambda: _walk(_denoiser(plain=True), tb, steps=k), tmp_path)
    top = [s for s in spans if not any(o is not s and o[1] <= s[1] and s[2] <= o[2] for o in spans)]
    assert [s[0] for s in top] == ["jamun.host.wait:graph_mask", "jamun.sample.batch"]
    batch = _children(spans, top[1])
    assert [s[0] for s in batch] == (
        ["jamun.walk.start"] + ["jamun.walk.step"] * (k - 1) + ["jamun.walk.jump", "jamun.sample.unbatch"])
    for step in batch[:-2]:
        (score,) = _children(spans, step)
        (xhat,) = _children(spans, score)
        (fwd,) = _children(spans, xhat)
        assert [score[0], xhat[0], fwd[0]] == [
            "jamun.denoiser.score", "jamun.denoiser.xhat", "jamun.e3conv.forward:plain"]
        assert _children(spans, fwd) == []
    assert [s[0] for s in _children(spans, batch[-2])] == ["jamun.denoiser.xhat"]  # the final state's jump
    assert [s[0] for s in _children(spans, batch[-1])] == ["jamun.host.wait:unbatch_copy"]


def test_a_fit_step_emits_its_phases_in_order(tmp_path):
    spans = _spans(_fit(tmp_path), tmp_path)
    (step,) = [s for s in spans if s[0] == "jamun.train.step"]
    assert [s[0] for s in _children(spans, step)] == [
        "jamun.train.to_device", "jamun.train.forward", "jamun.train.backward", "jamun.train.grad_norm",
        "jamun.train.optimizer", "jamun.train.ema", "jamun.train.log"]
    (log,) = [s for s in spans if s[0] == "jamun.train.log"]
    assert [s[0] for s in _children(spans, log)] == ["jamun.host.wait:log_read"]
    (fwd,) = [s for s in spans if s[0] == "jamun.train.forward"]
    assert [s[0] for s in _children(spans, fwd)] == ["jamun.denoiser.xhat"]
    assert "jamun.train.all_reduce" not in [s[0] for s in spans]  # one process: nothing to reduce
    quiet = _spans(_fit(tmp_path, log_every=1000), tmp_path)
    assert "jamun.train.log" not in [s[0] for s in quiet]


def _forward(regime):
    """A forward that takes `regime`'s branch of `E3Conv.forward`."""
    big = regime == "tiled"
    tb = make_test_batch(num_graphs=1, max_nodes=136 if big else 8, max_bonds=272 if big else 16,
                         scale=0.6 if big else 0.35, device="cpu")
    kw = {"plain": dict(plain=True), "stack": dict(fused_stack=True), "layerwise": {}, "tiled": {},
          "plane": dict(pallas_variant="plane"), "sparse": dict(neighbor_mode="nbr", neighbor_cap=4),
          "sharded": dict(plain=True)}[regime]
    arch = E3Conv(**ARCH, **kw).requires_grad_(False)
    c_noise = torch.tensor([-0.8])
    if regime == "sharded":
        return lambda: atom_sharded.atom_sharded_arch_apply(arch, mesh.Mesh(), tb, c_noise, 1.2)
    return lambda: arch(tb, c_noise, 1.2)


@pytest.mark.parametrize("regime", ["plain", "stack", "layerwise", "tiled", "plane", "sparse", "sharded"])
def test_the_forward_names_its_regime(regime, tmp_path):
    """Each branch of `E3Conv.forward` the CPU reaches (the kernel paths on
    their plain twins) opens one span named by it."""
    fwd = _forward(regime)
    with torch.no_grad():
        spans = _spans(fwd, tmp_path)
    assert [s[0] for s in spans] == [f"jamun.e3conv.forward:{regime}"]


def test_a_kernel_launch_is_a_span_and_still_counted(tmp_path):
    kernel = CudaKernel("e3_stack", {})
    kernel._lib = types.SimpleNamespace(run=lambda *args: 0)
    spans = _spans(lambda: [kernel.launch("run", 1, 2) for _ in range(3)], tmp_path)
    assert [s[0] for s in spans] == ["jamun.kernel:e3_stack"] * 3 and kernel.launches == 3
    kernel.launch("run")
    assert kernel.launches == 4


def test_span_is_the_only_way_in_and_every_name_is_the_programs():
    """No module of the port but `utils/trace.py` names `record_function`,
    and every span name written out starts with `jamun.`."""
    named, literal = [], re.compile(r"\bspan\(\s*(f?)\"([^\"]*)\"")
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        if path.name != "trace.py" and "record_function" in text:
            named.append(str(path))
        for f, name in literal.findall(text):
            assert name.startswith("jamun."), (path, name)
    assert named == []
    from jamun_tpu_torch.models import e3conv

    assert all(v == "jamun.e3conv.forward:" + k for k, v in e3conv._FORWARD_SPAN.items())
