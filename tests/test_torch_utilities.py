"""The port's utility modules and last public names against JAX's (CPU):
`utils/timing.timed_chain`, `ops/precision` and `utils/torch_setup` (the
CLIs call it first), `NoiseEmbedding`, `linear_embedding_transform`,
`spherical_harmonics_np`, `torch_linear_kernel_init` /
`torch_linear_bias_init`, `instantiate_dict_cfg` and
`visualize_denoise_metrics` (with the Trainer's `visualize_denoise_sigmas`).
Each tolerance is written beside its check.
"""

import ast
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.config.instantiate import instantiate_dict_cfg as j_instantiate_dict_cfg
from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.models.noise_conditioning import NoiseEmbedding as JNoiseEmbedding
from jamun_tpu.models.noise_conditioning import linear_embedding_transform as j_linear_embedding_transform
from jamun_tpu.ops.sh import spherical_harmonics_np as j_spherical_harmonics_np
from jamun_tpu.train.diagnostics import visualize_denoise_metrics as j_visualize_denoise_metrics
from jamun_tpu.utils import timing as j_timing
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.cmdline import sample as sample_cli
from jamun_tpu_torch.cmdline import train as train_cli
from jamun_tpu_torch.config.instantiate import instantiate, instantiate_dict_cfg
from jamun_tpu_torch.models import NoiseEmbedding
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.models.noise_conditioning import linear_embedding_transform
from jamun_tpu_torch.ops import precision
from jamun_tpu_torch.ops.mlp import Dense, torch_linear_bias_init, torch_linear_kernel_init
from jamun_tpu_torch.ops.sh import spherical_harmonics_np
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.train.diagnostics import visualize_denoise_metrics
from jamun_tpu_torch.train.distributions import ConstantSigma
from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
from jamun_tpu_torch.train.optim import adam
from jamun_tpu_torch.utils import timing
from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger, make_test_batch
from jamun_tpu_torch.utils.torch_setup import setup_torch

torch.set_num_threads(2)
REPO = os.path.join(os.path.dirname(__file__), "..")
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")
BATCH = dict(num_graphs=3, max_nodes=12, nodes_per_graph=[12, 10, 11], max_bonds=24, scale=0.35, seed=4)


# ---- timed_chain ----


@pytest.mark.parametrize("durations,steps,max_tries", [
    ((5e-6,), 2, 6),  # plausible at once
    ((1e-7, 2e-7, 5e-6, 1.0), 2, 6),  # two tries below the floor, the third counts
    ((1e-7,) * 3, 2, 3),  # every try below: None
    ((2e-6,), 2, 1),  # exactly the floor counts
    ((1e-3, 1e-3), 1000, 2),  # a longer chain raises the floor: None
])
def test_timed_chain_follows_jax(durations, steps, max_tries, monkeypatch):
    """The same stub run (each call advances a fake clock by the next of
    `durations`) through JAX's and the port's `timed_chain`: the same
    result (seconds or None) after the same number of tries; the port also
    synchronizes its device (the CPU: nothing to wait for)."""
    results = {}
    for name, fn in (("jax", j_timing.timed_chain), ("port", timing.timed_chain)):
        clock, calls = [0.0], [0]

        def run():
            clock[0] += durations[calls[0]]
            calls[0] += 1

        monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
        kw = {"device": "cpu"} if name == "port" else {}
        results[name] = (fn(run, steps, max_tries=max_tries, **kw), calls[0])
        monkeypatch.undo()
    assert results["port"] == results["jax"], results
    assert timing.MIN_S_PER_STEP == j_timing.MIN_S_PER_STEP == 1e-6


def test_timed_chain_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.timed_chain(lambda: None, 1)


# ---- the precision policy ----


def test_setup_torch_pins_f32(monkeypatch):
    """`setup_torch` turns TF32 off in cuBLAS and cuDNN, f32 matmuls to
    "highest" and 16-bit reduced-precision reductions off, whatever they
    were; `matmul_precision` gives the rule by compute dtype."""
    m = torch.backends.cuda.matmul
    monkeypatch.setattr(m, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(m, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(m, "allow_fp16_reduced_precision_reduction", True)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        setup_torch()
        assert not m.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
        assert not m.allow_bf16_reduced_precision_reduction
        assert not m.allow_fp16_reduced_precision_reduction
    finally:
        torch.set_float32_matmul_precision(before)
    assert precision.matmul_precision(None) == precision.matmul_precision(torch.float32) == "highest"
    assert precision.matmul_precision("bfloat16") == "bf16-inputs-f32-accumulate"
    assert precision.matmul_precision(torch.float16) == "f16-inputs-f32-accumulate"


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli", [train_cli, sample_cli], ids=["train", "sample"])
def test_both_clis_call_setup_torch_first(cli, monkeypatch):
    """Each CLI's `run` calls `setup_torch` before anything else, as JAX's
    calls `setup_jax`: a spy that stops the run there is reached with an
    empty config (anything read before it would raise first), after TF32
    was turned on, and leaves it off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    calls = []

    def spy():
        setup_torch()
        calls.append(torch.backends.cuda.matmul.allow_tf32)
        raise _Stop

    monkeypatch.setattr(cli, "setup_torch", spy)
    with pytest.raises(_Stop):
        cli.run({})
    assert calls == [False]
    # and JAX's CLI module calls setup_jax at the same place
    src = open(os.path.join(REPO, "jamun_tpu", "cmdline", f"{cli.__name__.rsplit('.', 1)[1]}.py")).read()
    run = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name == "run")
    assert "setup_jax()" in ast.unparse(run)


# ---- the last public names ----


@pytest.mark.parametrize("num_layers", [0, 2, 3])
def test_noise_embedding_matches_jax(num_layers):
    """`NoiseEmbedding` from JAX's parameters (flax names `Dense_k`), on a
    batch of c_noise values, 1e-6 of the max; the port's seeded init keeps
    torch.nn.Linear's bounds, as JAX's does."""
    jm = JNoiseEmbedding(output_dims=24, num_layers=num_layers)
    c = np.linspace(-1.5, 0.5, 5).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(c))
    want = np.asarray(jm.apply(params, jnp.asarray(c)))
    tm = NoiseEmbedding(24, num_layers)
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(c)).numpy()
    assert got.shape == want.shape == (5, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    seeded = NoiseEmbedding(24, num_layers)
    seeded.Dense_0.reset_parameters(torch.Generator().manual_seed(0))
    assert float(seeded.Dense_0.kernel.detach().abs().max()) <= 1.0
    # JAX's config target resolves to the port's class
    built = instantiate({"_target_": "jamun_tpu.models.NoiseEmbedding", "output_dims": 24,
                         "num_layers": num_layers})
    assert type(built) is NoiseEmbedding and set(built.state_dict()) == set(tm.state_dict())


def test_linear_embedding_transform_and_initializers():
    sigma = np.array([0.01, 0.04, 0.3], np.float32)
    np.testing.assert_allclose(
        linear_embedding_transform(torch.from_numpy(sigma), 2.5, -0.1).numpy(),
        np.asarray(j_linear_embedding_transform(jnp.asarray(sigma), 2.5, -0.1)), rtol=1e-6)
    assert linear_embedding_transform(0.5) == j_linear_embedding_transform(0.5) == 0.5
    # torch.nn.Linear's bounds, and Dense draws kernel then bias through them
    g = torch.Generator().manual_seed(5)
    k = torch_linear_kernel_init(g, (16, 4))
    b = torch_linear_bias_init(16)(g, (4,))
    assert k.shape == (16, 4) and b.shape == (4,) and k.dtype == torch.float32
    assert float(k.abs().max()) <= 0.25 and float(b.abs().max()) <= 0.25 and float(k.abs().max()) > 0.1
    d = Dense(16, 4)
    d.reset_parameters(torch.Generator().manual_seed(5))
    torch.testing.assert_close(d.kernel.data, k, rtol=0, atol=0)
    torch.testing.assert_close(d.bias.data, b, rtol=0, atol=0)


@pytest.mark.parametrize("irreps_sh", ["1x0e + 1x1e", "1x0e + 1x1e + 1x2e", "2x1e"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spherical_harmonics_np_matches_jax(irreps_sh, normalize, dtype):
    v = np.random.default_rng(8).standard_normal((7, 3)).astype(dtype)
    got = spherical_harmonics_np(irreps_sh, v, normalize=normalize)
    want = j_spherical_harmonics_np(irreps_sh, v, normalize=normalize)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert got.dtype == dtype  # the port keeps f64 in f64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_instantiate_dict_cfg_follows_jax():
    """Only the entries with a `_target_` are instantiated, in the dict's
    order; the port's resolver maps JAX's targets onto its own classes."""
    cfg = {
        "first": {"_target_": "jamun_tpu.train.distributions.ConstantSigma", "sigma": 0.1},
        "plain": {"sigma": 0.2},
        "scalar": 3,
        "second": {"_target_": "jamun_tpu.train.distributions.UniformSigma", "sigma_max": 0.2,
                   "sigma_min": 0.01},
    }
    got, want = instantiate_dict_cfg(cfg), j_instantiate_dict_cfg(cfg)
    assert [type(o).__name__ for o in got] == [type(o).__name__ for o in want] == [
        "ConstantSigma", "UniformSigma"]
    assert all(type(o).__module__.startswith("jamun_tpu_torch.") for o in got)
    assert (got[0].sigma, got[1].sigma_min, got[1].sigma_max) == (
        want[0].sigma, want[1].sigma_min, want[1].sigma_max)
    assert instantiate_dict_cfg({}) == instantiate_dict_cfg(None) == j_instantiate_dict_cfg({}) == []


# ---- denoise visualization ----


def _denoisers():
    config = dict(max_radius=1.0, average_squared_distance=0.3, add_fixed_ones=True)
    jb = j_make_test_batch(**BATCH)
    jden = JDenoiser(JE3Conv(**ARCH, use_pallas=False), JConfig(**config))
    params = jden.init(jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(11)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32),
                          params)
    arch = E3Conv(**ARCH, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    return jden, params, jb, Denoiser(arch, DenoiserConfig(**config))


def test_visualize_denoise_metrics_matches_jax():
    """Per sigma, every metric of JAX's `visualize_denoise_metrics` with the
    noise injected on both sides (`add_fixed_ones`), from the same
    parameters, on a batch with a padded graph: 1e-5 relative."""
    jden, params, jb, den = _denoisers()
    jb = jb.replace(graph_mask=jnp.asarray([True, True, False]))
    tb = dataclasses.replace(make_test_batch(**BATCH, device="cpu"),
                             graph_mask=torch.tensor([True, True, False]))
    sigmas = (0.02, 0.04, 0.08)
    want = j_visualize_denoise_metrics(jden, params, jb, sigmas=sigmas)
    got = visualize_denoise_metrics(den, den.arch, tb, sigmas=sigmas)
    assert list(got) == list(want) == list(sigmas)
    for s in sigmas:
        assert set(got[s]) == set(want[s]) and "scaled_rmsd" in got[s]
        for k, v in want[s].items():
            assert abs(got[s][k] - v) <= 1e-5 * abs(v), (s, k, got[s][k], v)


def test_trainer_logs_denoise_metrics(tmp_path):
    """`TrainerConfig(visualize_denoise_sigmas=...)` logs
    `val/scaled_rmsd_sigma{s}` beside the validation losses, finite, from
    the EMA weights on the first validation batch."""
    _, _, _, den = _denoisers()
    tb = make_test_batch(**BATCH, device="cpu")
    rec = RecordingLogger()
    cfg = TrainerConfig(max_steps=2, log_every_n_steps=1, val_every_n_steps=2,
                        checkpoint_dir=str(tmp_path / "ckpt"), visualize_denoise_sigmas=(0.02, 0.08))
    Trainer(cfg, rec, device="cpu").fit(den, adam(1e-3), ConstantSigma(0.04), FixedBatches([tb], [tb]))
    val = [m for _, m in rec.metrics if "val/loss" in m]
    assert len(val) == 1
    for s in (0.02, 0.08):
        assert np.isfinite(val[0][f"val/scaled_rmsd_sigma{s}"])


# ---- the public names of the two packages ----


def _public_defs(path: str) -> set:
    """The public functions and classes a module defines at its top level."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_no_public_name_of_a_ported_module_is_missing():
    """An AST diff of the two trees: every public function and class of a
    JAX module (the Pallas kernels aside: `ops/cuda/` holds theirs) is
    defined in the port's module of the same path, except
    `denoiser_without_kernels` (JAX's kernel fallback, left out on purpose:
    a failing kernel raises in the port), and `utils/jax_setup.py`'s
    `setup_jax` is `utils/torch_setup.py`'s `setup_torch`. `parallel/` is
    held too."""
    root_j, root_t = os.path.join(REPO, "jamun_tpu"), os.path.join(REPO, "jamun_tpu_torch")
    renamed = {os.path.join("utils", "jax_setup.py"): (os.path.join("utils", "torch_setup.py"),
                                                       {"setup_jax": "setup_torch"})}
    missing, modules = {}, 0
    for d, _, fs in os.walk(root_j):
        for f in sorted(fs):
            rel = os.path.relpath(os.path.join(d, f), root_j)
            if not f.endswith(".py") or rel.startswith(os.path.join("ops", "pallas")):
                continue
            port_rel, names = renamed.get(rel, (rel, {}))
            want = {names.get(n, n) for n in _public_defs(os.path.join(root_j, rel))}
            gone = want - _public_defs(os.path.join(root_t, port_rel))
            modules += 1
            if gone:
                missing[rel] = sorted(gone)
    assert modules > 60
    assert missing == {os.path.join("train", "loop.py"): ["denoiser_without_kernels"]}, missing


# ---- the prefetch thread ends with its consumer ----


@pytest.mark.parametrize("how", ["close", "break", "exhaust"])
def test_prefetch_thread_is_joined_when_the_consumer_stops(how):
    """A consumer that stops early (closes the generator, or breaks out of
    its loop, as `Trainer.fit` does at `max_steps`) or runs it to its end
    leaves no prefetch thread behind: the thread is stopped and joined before
    the consumer goes on, so a process that exits right after a training
    run cannot end while the thread is still collating. Found on the card:
    a script that exited right after 5 steps of the train CLI aborted
    ("terminate called without an active exception")."""
    import threading

    from jamun_tpu_torch.data.datamodule import PREFETCH_THREAD, DataModule

    from jamun_tpu_torch.data.peptide_builder import build_peptide
    from jamun_tpu_torch.data.topology import preprocess_topology

    top, pos = build_peptide("AG")
    template = preprocess_topology(top, pos)[0]

    class Slow:
        def __init__(self):
            self.template = template

        def __len__(self):
            return 40

        def __getitem__(self, i):
            time.sleep(0.01)
            return template, pos

    def alive():
        return [t for t in threading.enumerate() if t.name == PREFETCH_THREAD]

    dm = DataModule(datasets=[Slow()], batch_size=4, prefetch=2)
    gen = dm.train_batches(0)
    if how == "close":
        next(gen)
        assert alive()
        gen.close()
    elif how == "break":
        for n, _ in enumerate(gen):
            if n == 1:
                break
        del gen
    else:
        assert len(list(gen)) == 10
    assert not alive()
