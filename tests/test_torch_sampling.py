"""The port's sampling loop against JAX (CPU, f32): the ABOBA step under
injected noise, the unfused jump, the chunked host-offload walk, `Sampler`
with its callbacks, `unbatch_samples`, the parameter callbacks, and the
device rule.

JAX and PyTorch draw different numbers from a seed, so a step is compared
with the Gaussian draws handed to both sides from numpy; walks are compared
on their save grid and against the port's own unchunked walk.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.sampling import callbacks as j_callbacks
from jamun_tpu.sampling.mcmc import ABOBA as JABOBA, BAOAB as JBAOAB, MCMCConfig as JMCMCConfig
from jamun_tpu.sampling.mcmc import make_processed_score_fn as j_processed
from jamun_tpu.sampling.sampler import Sampler as JSampler, unbatch_samples as j_unbatch_samples
from jamun_tpu.sampling.walkjump import SingleMeasurementSampler as JSingleMeasurementSampler
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.sampling import callbacks
from jamun_tpu_torch.sampling.mcmc import ABOBA, BAOAB, MCMCConfig, make_processed_score_fn
from jamun_tpu_torch.sampling.sampler import Sampler, unbatch_samples
from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=1, tensor_product="uvu")
BATCH = dict(num_graphs=2, max_nodes=8, max_bonds=16, scale=0.35)


def _setup(seed=0, fused_stack=True):
    jb, tb = j_make_test_batch(**BATCH, seed=seed), make_test_batch(**BATCH, seed=seed, device="cpu")
    jden = JDenoiser(JE3Conv(**ARCH, use_pallas=False), JConfig(1.0, 0.5))
    params = jden.init(jax.random.PRNGKey(seed), jb)
    rng = np.random.default_rng(300 + seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32), params
    )
    arch = E3Conv(**ARCH, fused_stack=fused_stack, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    arch.requires_grad_(False)
    return jden, params, jb, Denoiser(arch, DenoiserConfig(1.0, 0.5)), tb


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_aboba_step_matches_jax():
    """Three ABOBA steps with the same injected Gaussian draws, the real
    denoiser scores on both sides (the port on its stack path) and an active
    norm clip; then the save grid and the initial score of a whole walk."""
    jden, params, jb, den, tb = _setup(seed=3)
    cfg_kw = dict(delta=0.04, friction=1.0, M=1.0, steps=4, score_fn_clip=5.0)
    jcfg, cfg = JMCMCConfig(**cfg_kw), MCMCConfig(**cfg_kw)
    rng = np.random.default_rng(9)
    draws = [rng.standard_normal(jb.pos.shape).astype(np.float32) for _ in range(3)]
    it = iter(draws)
    jscore = jax.jit(lambda y: jden.score(params, jb.replace_pos(y), SIGMA))
    jproc = j_processed(jscore, 1.0, cfg.score_fn_clip)
    v0 = rng.standard_normal(jb.pos.shape).astype(np.float32)
    with torch.no_grad():
        tproc = make_processed_score_fn(lambda y: den.score(tb.replace_pos(y), SIGMA), 1.0, 5.0)
        sampler = ABOBA(cfg)
        carry = sampler._init_carry(tb.pos, torch.from_numpy(v0), tproc)
        jcarry = JABOBA(jcfg)._init_carry(jnp.asarray(jb.pos), jnp.asarray(v0), jproc)
        damp, zeta2 = np.exp(-1.0), np.sqrt(1.0 - np.exp(-2.0))
        for R in draws:
            carry = sampler.step(carry, torch.from_numpy(R), tproc)
            jcarry = JABOBA._step(
                jcarry, None, jproc, jcfg, damp, zeta2, 1.0, lambda k, s, d: jnp.asarray(next(it))
            )
            assert float(carry[3].norm(dim=-1).max()) > 5.0  # the clip is active
            # (y, v, raw midpoint score), each held relative to its max
            for a, b in zip((carry[0], carry[1], carry[3]), jcarry[:3]):
                assert _rel_err(a.numpy(), np.asarray(b)) < 1e-4

    # a whole walk: ABOBA's frame 0 carries the score at the initial state
    kw = dict(steps=10, save_every_n_steps=3, delta=0.1)
    y0 = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
    _, _, jtraj, jscores = JABOBA(JMCMCConfig(**kw))(jax.random.PRNGKey(0), jnp.asarray(y0), lambda y: -y)
    _, _, traj, scores = ABOBA(MCMCConfig(**kw))(
        torch.from_numpy(y0), lambda y: -y, torch.Generator().manual_seed(0)
    )
    assert traj.shape == tuple(jtraj.shape) == (4, 2, 5, 3)
    np.testing.assert_array_equal(scores[0].numpy(), -y0)
    np.testing.assert_array_equal(np.asarray(jscores[0]), -y0)
    # later frames carry the midpoint score, which is not the score at the frame
    assert not np.allclose(scores[1].numpy(), -traj[1].numpy())


@pytest.mark.parametrize("jump_chunk_size", [0, 2])
def test_unfused_jump_is_xhat_per_frame(jump_chunk_size):
    """ABOBA (and BAOAB with fused_jump off) jump every saved frame through
    `denoiser.xhat`; BAOAB's fused jump gives the same frames."""
    _, _, _, den, tb = _setup(seed=1)
    cfg = MCMCConfig(delta=0.04, steps=6, score_fn_clip=100.0)
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    for mcmc, fused in ((ABOBA(cfg), True), (BAOAB(cfg), False)):
        out = SingleMeasurementSampler(mcmc, SIGMA, jump_chunk_size, fused).walk_jump(
            den, tb, tb.pos, gen()
        )
        assert out["xhat_traj"].shape == (6, 2, 8, 3)
        with torch.no_grad():
            for k in range(6):
                want = den.xhat(tb.replace_pos(out["y_traj"][k]), SIGMA)
                torch.testing.assert_close(out["xhat_traj"][k], want, rtol=1e-5, atol=1e-6)
    fused_out = SingleMeasurementSampler(BAOAB(cfg), SIGMA).walk_jump(den, tb, tb.pos, gen())
    torch.testing.assert_close(fused_out["y_traj"], out["y_traj"], rtol=0, atol=0)
    # score = (xhat - y) / sigma^2 amplifies xhat's f32 error by 625 and the
    # fused jump scales it back
    torch.testing.assert_close(fused_out["xhat_traj"], out["xhat_traj"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("steps,save_every,chunk", [(12, 1, 4), (14, 2, 4), (9, 1, 3), (5, 1, 8)])
def test_sample_chunked_lands_on_the_save_grid(steps, save_every, chunk):
    """The chunked walk saves the frames of the unchunked walk's absolute
    grid (as JAX's does), as host arrays. The port's chunks draw from one
    generator in the unchunked walk's order, so the frames are the unchunked
    walk's own (JAX splits a key per chunk and agrees only in distribution)."""
    _, _, _, den, tb = _setup(seed=2)
    cfg = MCMCConfig(delta=0.04, steps=steps, save_every_n_steps=save_every, friction=1.0,
                     score_fn_clip=100.0)
    plain = SingleMeasurementSampler(BAOAB(cfg), SIGMA)
    chunked = dataclasses.replace(plain, offload_chunk_steps=chunk)
    a = plain.sample(den, tb, tb.pos, torch.Generator().manual_seed(5), "zero")
    b = chunked.sample_chunked(den, tb, tb.pos, torch.Generator().manual_seed(5), "zero")
    frames = cfg.num_saved_frames
    jcfg = JMCMCConfig(delta=0.04, steps=steps, save_every_n_steps=save_every)
    assert frames == jcfg.num_saved_frames
    for k in ("y_traj", "score_traj", "xhat_traj"):
        assert isinstance(b[k], np.ndarray) and b[k].shape == (frames, 2, 8, 3) == tuple(a[k].shape)
    for k in ("y", "v", "xhat", "sample"):
        assert torch.is_tensor(b[k]) and b[k].shape == (2, 8, 3)
    # the same generator draws the same noise in the same order, and BAOAB's
    # carried score is re-evaluated at each chunk's start: the same walk
    np.testing.assert_allclose(b["y_traj"], a["y_traj"].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b["xhat_traj"], a["xhat_traj"].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b["y"].numpy(), a["y"].numpy(), rtol=1e-5, atol=1e-6)


def test_sample_chunked_errors():
    _, _, _, den, tb = _setup()
    gen = torch.Generator().manual_seed(0)
    burn = SingleMeasurementSampler(BAOAB(MCMCConfig(steps=10, burn_in_steps=2)), SIGMA,
                                    offload_chunk_steps=4)
    with pytest.raises(NotImplementedError, match="burn_in_steps == 0"):
        burn.sample_chunked(den, tb, tb.pos, gen)
    off_grid = SingleMeasurementSampler(BAOAB(MCMCConfig(steps=10, save_every_n_steps=3)), SIGMA,
                                        offload_chunk_steps=4)
    with pytest.raises(ValueError, match="multiple of save_every_n_steps"):
        off_grid.sample_chunked(den, tb, tb.pos, gen)
    # JAX raises the same two
    jden, params, jb, _, _ = _setup()
    for jcfg, exc in ((JMCMCConfig(steps=10, burn_in_steps=2), NotImplementedError),
                      (JMCMCConfig(steps=10, save_every_n_steps=3), ValueError)):
        js = JSingleMeasurementSampler(JBAOAB(jcfg), SIGMA, offload_chunk_steps=4)
        with pytest.raises(exc):
            js.sample_chunked(jden, params, jb, jax.random.PRNGKey(0), jnp.asarray(jb.pos))


class _Recorder:
    def __init__(self):
        self.events = []

    def on_sample_start(self, sampler):
        self.events.append(("start", type(sampler).__name__))

    def on_after_sample_batch(self, sample, sampler, elapsed_seconds, neighbor_overflow):
        self.events.append(("batch", sampler.global_step, len(sample), sorted(sample[0]),
                            elapsed_seconds > 0, neighbor_overflow))

    def on_sample_end(self, sampler):
        self.events.append(("end", sampler.global_step))


@pytest.mark.parametrize("continue_chain", [True, False])
def test_sampler_batches_and_callbacks(continue_chain):
    """`Sampler.sample` over three batches: the hooks fire in JAX's order
    with JAX's arguments, the per-graph dicts have JAX's keys and shapes, a
    parameter callback changes delta per batch, and a continued chain starts
    each batch where the last one ended."""
    jden, params, jb, den, tb = _setup(seed=4)
    kw = dict(delta=0.04, steps=5, score_fn_clip=100.0)
    rec, jrec = _Recorder(), _Recorder()
    decay, jdecay = callbacks.DeltaSqrtDecayCallback(0.04), j_callbacks.DeltaSqrtDecayCallback(0.04)
    seen = []

    class Spy(SingleMeasurementSampler):
        def sample(self, denoiser, init_graphs, y_init, generator, v_init="gaussian"):
            seen.append((self.mcmc.config.delta, y_init.clone(), v_init))
            return super().sample(denoiser, init_graphs, y_init, generator, v_init)

    got = Sampler(callbacks=[rec, decay], device="cpu").sample(
        den, Spy(BAOAB(MCMCConfig(**kw)), SIGMA), 3, tb, continue_chain=continue_chain, seed=7
    )
    want = JSampler(callbacks=[jrec, jdecay]).sample(
        jden, params, JSingleMeasurementSampler(JBAOAB(JMCMCConfig(**kw)), SIGMA), 3, jb,
        continue_chain=continue_chain, seed=7,
    )
    assert rec.events == jrec.events
    assert [e[0] for e in rec.events] == ["start", "batch", "batch", "batch", "end"]
    assert rec.events[0] == ("start", "Sampler")
    assert [e[1] for e in rec.events[1:4]] == [0, 1, 2]
    assert len(got) == len(want) == 3
    for batch, jbatch in zip(got, want):
        assert len(batch) == len(jbatch) == 2
        for entry, jentry in zip(batch, jbatch):
            assert sorted(entry) == sorted(jentry)
            assert (entry["graph_index"], entry["num_atoms"]) == (jentry["graph_index"], jentry["num_atoms"])
            for k, v in jentry.items():
                if hasattr(v, "shape"):
                    assert entry[k].shape == v.shape and np.isfinite(entry[k]).all(), k
    assert [d for d, _, _ in seen] == pytest.approx([0.04, 0.04 / 2**0.5, 0.04 / 3**0.5])
    assert seen[0][2] == "gaussian"
    if continue_chain:
        # batch k + 1 starts from batch k's last state and velocity
        for k in (1, 2):
            n = got[k - 1][0]["num_atoms"]
            np.testing.assert_array_equal(seen[k][1][0, :n].numpy(), got[k - 1][0]["y"])
            assert torch.is_tensor(seen[k][2])
    else:
        assert all(v == "gaussian" for _, _, v in seen)
        assert not torch.equal(seen[1][1], seen[0][1])


def test_sampler_runs_chunked_and_is_reproducible():
    _, _, _, den, tb = _setup(seed=5)
    cfg = MCMCConfig(delta=0.04, steps=9, score_fn_clip=100.0)
    bs = SingleMeasurementSampler(BAOAB(cfg), SIGMA, offload_chunk_steps=4)
    runs = [Sampler(device="cpu").sample(den, bs, 2, tb, continue_chain=True, seed=3) for _ in range(2)]
    other = Sampler(device="cpu").sample(den, bs, 1, tb, seed=4)
    assert runs[0][1][1]["xhat_traj"].shape == (7, 9, 3)  # graph 1 has 7 atoms, 9 frames
    np.testing.assert_array_equal(runs[0][1][0]["xhat_traj"], runs[1][1][0]["xhat_traj"])
    assert not np.array_equal(runs[0][0][0]["y_traj"], other[0][0]["y_traj"])


def test_unbatch_samples_matches_jax():
    rng = np.random.default_rng(1)
    kw = dict(num_graphs=3, max_nodes=6, nodes_per_graph=[6, 4, 5], max_bonds=12)
    jb, tb = j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")
    gm = np.array([True, False, True])
    jb = jb.replace(graph_mask=jnp.asarray(gm))
    tb = dataclasses.replace(tb, graph_mask=torch.from_numpy(gm))
    arrays = {
        "y": rng.standard_normal((3, 6, 3)).astype(np.float32),
        "xhat_traj": rng.standard_normal((5, 3, 6, 3)).astype(np.float32),
        "y_traj": rng.standard_normal((3, 3, 6, 3)).astype(np.float32),  # frames == G
    }
    want = j_unbatch_samples({**{k: jnp.asarray(v) for k, v in arrays.items()}, "tag": "x"}, jb)
    got = unbatch_samples(
        {"y": torch.from_numpy(arrays["y"]), "xhat_traj": arrays["xhat_traj"],
         "y_traj": torch.from_numpy(arrays["y_traj"]), "tag": "x"}, tb,
    )
    assert [e["graph_index"] for e in got] == [e["graph_index"] for e in want] == [0, 2]
    for e, je in zip(got, want):
        assert sorted(e) == sorted(je) and e["num_atoms"] == je["num_atoms"]
        for k in arrays:
            np.testing.assert_array_equal(e[k], np.asarray(je[k]))
    assert got[1]["xhat_traj"].shape == (5, 5, 3)  # [atoms, frames, 3]


def test_parameter_callbacks_match_jax():
    bs = SingleMeasurementSampler(BAOAB(MCMCConfig(delta=0.1, friction=0.5)), SIGMA)
    jbs = JSingleMeasurementSampler(JBAOAB(JMCMCConfig(delta=0.1, friction=0.5)), SIGMA)
    interp = dict(start={"delta": 0.1, "friction": 1.0}, end={"delta": 0.02, "friction": 2.0},
                  num_batches=4)
    table = [{"delta": 0.3, "sigma": 0.1}, {"friction": 0.7}]
    pairs = [
        (callbacks.InterpolateParametersCallback(**interp), j_callbacks.InterpolateParametersCallback(**interp)),
        (callbacks.MeasurementDependentParametersCallback(table),
         j_callbacks.MeasurementDependentParametersCallback([dict(r) for r in table])),
    ]
    for cb, jcb in pairs:
        for idx in (0, 1, 5):
            a, b = cb.update_sampler(bs, idx), jcb.update_sampler(jbs, idx)
            assert isinstance(a.mcmc, BAOAB) and a.sigma == b.sigma
            assert dataclasses.asdict(a.mcmc.config) == dataclasses.asdict(b.mcmc.config)
    # a second pass over the table finds its sigma again
    assert pairs[1][0].update_sampler(bs, 0).sigma == 0.1


def test_unported_options_and_device_rule():
    with pytest.raises(NotImplementedError, match="queue A, .Parallel."):
        Sampler(num_devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A, .Parallel."):
        Sampler(atom_sharded=True, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A, .Parallel."):
        Sampler(mesh=object(), device="cpu")
    # the Verlet lists of the sparse path are ported: a skin is accepted, and
    # a model on the dense path builds no list to cache
    smp = SingleMeasurementSampler(BAOAB(MCMCConfig(steps=3)), SIGMA, neighbor_skin=0.1)
    assert smp.neighbor_skin == 0.1
    tb = make_test_batch(1, 8, device="cpu")
    den = Denoiser(E3Conv(
        tensor_product="uvu", irreps_hidden="4x0e + 2x1e", n_layers=1, device="cpu", seed=0),
                   DenoiserConfig(1.0, 0.5))
    assert den.make_neighbor_cached_score(tb, SIGMA, 0.1) is None
    out = smp.walk(den, tb, tb.pos, torch.Generator().manual_seed(0))
    assert "neighbor_rebuilds" not in out and out["y_traj"].shape == (3, 1, 8, 3)
    assert Sampler(num_devices=1, device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Sampler()  # the default is the card
    assert not hasattr(Sampler(device="cpu"), "donate_state")
