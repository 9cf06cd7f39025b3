"""The port's VE-SDE sampler and `UnrolledBAOAB` against JAX's (CPU, f32).

VESDE: the schedule; N = 8 steps with JAX's own draws fed in as the start
and each step's `z`, on a small E3Conv (`16x0e + 8x1e`, 2 layers, uvu: the
port's kernel path through the plain twins, JAX's XLA path) and on
Ophiuchus (`8x0e + 8x1e`, 2 layers, `mul_factor` 8); and
`batch_sampler=vesde` from the sample config through the port's `Sampler`
and its callbacks. UnrolledBAOAB: the port's BAOAB's frames bit for bit on
one generator, JAX's frame count, and the variance of a harmonic well.
Parameters: JAX's `init`, every leaf moved by seeded noise (E3Conv's
output gain starts at 0). Each tolerance is written beside its check.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.data import batching as jbatching
from jamun_tpu.data import peptide_builder as jpeptides
from jamun_tpu.data import topology as jtopology
from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.models.ophiuchus import Ophiuchus as JOphiuchus
from jamun_tpu.sampling.mcmc import MCMCConfig as JMCMCConfig
from jamun_tpu.sampling.sampler import Sampler as JSampler
from jamun_tpu.sampling.unrolled import UnrolledBAOAB as JUnrolledBAOAB
from jamun_tpu.sampling.vesde import VESDEReverseDiffusionSampler as JVESDE
from jamun_tpu_torch.cmdline.sample import DEFAULT_CONFIG_DIR
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.metrics.base import MeasureSamplingTimeCallback
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.models.ophiuchus import Ophiuchus
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.sampling import BAOAB, MCMCConfig, Sampler, UnrolledBAOAB
from jamun_tpu_torch.sampling import VESDEReverseDiffusionSampler

torch.set_num_threads(2)
REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
EXP_DIR = os.path.join(REPO, "configs", "experiment")
CONFIG = dict(max_radius=1.0, average_squared_distance=0.3)
ARCHS = {
    "e3conv": (JE3Conv, E3Conv, dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")),
    "ophiuchus": (JOphiuchus, Ophiuchus, dict(irreps_hidden="8x0e + 8x1e", n_layers=2, mul_factor=8,
                                              edge_attr_dim=8, residue_code_embedding_dim=8)),
}


def _jax_batch():
    """Two copies of KWFE (`build_peptide`, 44 heavy atoms in the 48-atom
    bucket, four residues) and a dummy graph."""
    top, pos = jpeptides.build_peptide("KWFE")
    template = jtopology.preprocess_topology(top, pos)[0]
    pos = pos.astype(np.float32)
    return jbatching.collate([(template, pos), (template, pos[::-1].copy())], num_graphs=3)


def _port(jb) -> GraphBatch:
    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x.copy())

    return GraphBatch(**{f.name: t(getattr(jb, f.name)) for f in dataclasses.fields(GraphBatch)})


def _denoisers(name: str):
    jcls, cls, kw = ARCHS[name]
    jarch = jcls(**kw, use_pallas=False) if name == "e3conv" else jcls(**kw)
    jden = JDenoiser(jarch, JConfig(**CONFIG))
    jb = _jax_batch()
    params = jden.init(jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(9)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )
    arch = cls(**kw, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    arch.requires_grad_(False)
    return jden, params, jb, Denoiser(arch, DenoiserConfig(**CONFIG)), _port(jb)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("N", [2, 8, 1000])
def test_schedule_equals_jax(N):
    """sigmas and ts in f32: the port rounds each once from f64, JAX's XLA
    arithmetic lands within 1e-6 relative (sigmas) and 1e-7 absolute (ts)
    of those values."""
    sampler = VESDEReverseDiffusionSampler(N=N)
    sigmas, ts = sampler.schedule()
    assert sigmas.dtype == ts.dtype == np.float32 and sigmas.shape == ts.shape == (N,)
    js = np.asarray(jnp.exp(jnp.linspace(np.log(0.01), np.log(50.0), N)))
    jt = np.asarray(jnp.linspace(1.0, 1e-5, N))
    assert np.abs(sigmas / js - 1).max() <= 1e-6
    assert np.abs(ts - jt).max() <= 1e-7
    assert sigmas[0] == np.float32(0.01) and ts[0] == 1.0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_vesde_trajectories_equal_jax_on_injected_draws(name):
    """N = 8 from JAX's start and draws (its own key splits): y_traj,
    y_mean_traj and xhat_traj within 1e-4 of each one's max; the sample is
    the last y_mean, v zeros, the shapes JAX's [N, G, n, 3]."""
    jden, params, jb, den, tb = _denoisers(name)
    sampler, jsampler = VESDEReverseDiffusionSampler(N=8), JVESDE(N=8)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, k: jsampler.sample(jden, p, jb, k))(params, key)

    mask = np.asarray(jb.node_mask)[..., None].astype(np.float32)
    key, ikey = jax.random.split(key)
    y0 = sampler.sigma_max * np.asarray(jax.random.normal(ikey, jb.pos.shape)) * mask
    draws = []
    for _ in range(sampler.N):
        key, zkey = jax.random.split(key)
        draws.append(torch.from_numpy(np.asarray(jax.random.normal(zkey, jb.pos.shape)) * mask))
    got = sampler.anneal(den, tb, torch.from_numpy(y0), iter(draws).__next__)
    for k in ("y_traj", "y_mean_traj", "xhat_traj"):
        assert got[k].shape == want[k].shape == (8, *jb.pos.shape), k
        assert _rel(got[k].numpy(), want[k]) <= 1e-4, (k, _rel(got[k].numpy(), want[k]))
    assert torch.equal(got["sample"], got["y_mean_traj"][-1]) and not got["v"].any()
    assert _rel(got["sample"].numpy(), want["sample"]) <= 1e-4


class _Recorder:
    def __init__(self):
        self.calls = []

    def on_sample_start(self, sampler):
        self.calls.append("start")

    def on_after_sample_batch(self, sample, sampler, elapsed_seconds, neighbor_overflow):
        self.calls.append(("batch", len(sample), neighbor_overflow))

    def on_sample_end(self, sampler):
        self.calls.append("end")


def test_vesde_from_config_through_the_sampler():
    """`batch_sampler=vesde` (the port selects the group file, as Hydra
    does) builds the sampler; `Sampler.sample` runs two batches of it with
    the callbacks; each graph's dict has the keys and shapes of JAX's
    `Sampler` on the same sampler."""
    cfg = compose(DEFAULT_CONFIG_DIR, "sample",
                  ["experiment=sample_test", "batch_sampler=vesde", "batch_sampler.N=4"], EXP_DIR)
    sampler = instantiate(cfg["batch_sampler"])
    assert isinstance(sampler, VESDEReverseDiffusionSampler) and (sampler.N, sampler.sigma) == (4, 50.0)
    jden, params, jb, den, tb = _denoisers("e3conv")
    rec, timing = _Recorder(), MeasureSamplingTimeCallback()
    out = Sampler(callbacks=[rec, timing], device="cpu").sample(
        den, sampler, num_batches=2, init_graphs=tb, continue_chain=True, seed=1)
    want = JSampler().sample(jden, params, JVESDE(N=4), num_batches=1, init_graphs=jb)
    assert rec.calls == ["start", ("batch", 2, None), ("batch", 2, None), "end"]
    assert timing.total_samples == 2 * 2 * 4
    for batch in out:
        assert [s["graph_index"] for s in batch] == [0, 1]
        for got, ref in zip(batch, want[0]):
            assert sorted(got) == sorted(ref)
            for k, v in ref.items():
                assert np.shape(got[k]) == np.shape(v), k
            assert np.isfinite(got["xhat_traj"]).all() and got["xhat_traj"].shape == (44, 4, 3)


# ---- UnrolledBAOAB ----

@pytest.mark.parametrize("steps,chunk,save_every", [(13, 4, 1), (14, 4, 2), (13, 12, 3)])
def test_unrolled_equals_baoab_bit_for_bit(steps, chunk, save_every):
    """The small E3Conv's score (kernel path: the plain twins), masked,
    clipped: on one generator the frames are BAOAB's bit for bit (BAOAB
    run for the updates the chunks cover); the score trajectory is zeros."""
    _, _, _, den, tb = _denoisers("e3conv")
    mask = tb.node_mask[..., None].float()
    updates = (steps - 1) // chunk * chunk
    cfg = MCMCConfig(delta=0.04, steps=steps, save_every_n_steps=save_every, score_fn_clip=100.0)

    def score(y):
        return den.score(tb.replace_pos(y), 0.04)

    y0 = tb.pos + 0.04 * torch.randn(tb.pos.shape, generator=torch.Generator().manual_seed(0)) * mask
    with torch.no_grad():
        y, v, traj, scores = UnrolledBAOAB(cfg, chunk_steps=chunk)(
            y0, score, torch.Generator().manual_seed(5), "gaussian", mask)
        wy, wv, wtraj, _ = BAOAB(dataclasses.replace(cfg, steps=updates + 1))(
            y0, score, torch.Generator().manual_seed(5), "gaussian", mask)
    assert traj.shape == wtraj.shape and traj.shape[0] == 1 + updates // save_every
    assert torch.equal(traj.view(torch.int32), wtraj.view(torch.int32))
    assert torch.equal(y, wy) and torch.equal(v, wv)
    assert not scores.any() and scores.shape == traj.shape


@pytest.mark.parametrize("steps,chunk,save_every", [(101, 20, 10), (101, 25, 1), (100, 25, 3),
                                                    (7, 3, 2), (2, 5, 1)])
def test_unrolled_frame_count_equals_jax(steps, chunk, save_every):
    y0 = np.ones((4, 3), np.float32)
    jcfg = JMCMCConfig(delta=0.01, steps=steps, save_every_n_steps=save_every)
    _, _, want, _ = JUnrolledBAOAB(jcfg, chunk_steps=chunk)(
        jax.random.PRNGKey(0), jnp.asarray(y0), lambda x: -x)
    cfg = MCMCConfig(delta=0.01, steps=steps, save_every_n_steps=save_every)
    _, _, got, _ = UnrolledBAOAB(cfg, chunk_steps=chunk)(
        torch.from_numpy(y0), lambda x: -x, torch.Generator().manual_seed(0))
    assert got.shape == want.shape


def test_unrolled_harmonic_well_variance():
    """A harmonic well of stiffness k: the frames' variance is 1/k within
    30% (`tests/test_unrolled.py`'s check)."""
    k = 4.0
    cfg = MCMCConfig(delta=0.05, friction=1.0, steps=2001, save_every_n_steps=1)
    _, _, traj, _ = UnrolledBAOAB(cfg, chunk_steps=50)(
        torch.zeros((64, 3)), lambda x: -k * x, torch.Generator().manual_seed(0))
    assert traj.shape[0] == 1 + 2000
    var = float(traj[10:].reshape(-1).var())
    assert abs(var - 1.0 / k) < 0.3 / k, var
