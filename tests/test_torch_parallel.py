"""The port's `parallel/` against JAX's (CPU, gloo).

The host-side helpers (`partition_bonds_by_dst`, `pad_batch_to_multiple`,
`pad_atoms_to_multiple`, `prepare_atom_sharded_batch`,
`resolve_atom_sharded`) give JAX's arrays exactly. The rest runs on two
gloo ranks started by `parallel.launch.spawn` (rendezvous through a file in
the test's temporary directory; each case has its own deadline): the
atom-sharded E3Conv forward, dense and sparse, against JAX's
`atom_sharded_arch_apply` on two devices of the virtual CPU mesh
(`tests/conftest.py`) and against the single-process port, with its
gradients (and over the mesh of one process against JAX's one-device
mesh); the atom-sharded and the data-parallel train steps through
`Trainer.fit` against the single-process port and JAX's steps on a
two-device mesh (noise of ones on both sides, `add_fixed_ones`; the
data-parallel batch of three graphs puts a masked dummy graph on the last
rank); `Sampler(num_devices=2)` and `Sampler(atom_sharded=True)` against
the plain `Sampler`; and the train CLI on two ranks, where rank 0 alone
writes the run directory. Tolerances, f32: forwards 1e-5 of the output's
largest entry, gradients and parameters 1e-4 of each leaf's, losses 1e-5
relative, samples 1e-4 of each array's largest entry.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.parallel import atom_sharded as jas
from jamun_tpu.parallel import mesh as jmesh
from jamun_tpu.train import distributions as jdist
from jamun_tpu.train.state import TrainState as JTrainState
from jamun_tpu.train.state import make_train_step as j_make_train_step
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.parallel import atom_sharded as pas
from jamun_tpu_torch.parallel import distributed, launch
from jamun_tpu_torch.parallel import mesh as pmesh
from jamun_tpu_torch.utils.testing import make_test_batch

torch.set_num_threads(2)
REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
SIGMA = 0.04
ARCH = dict(irreps_hidden="16x0e + 8x1e", n_layers=2, tensor_product="uvu")
CONFIG = dict(max_radius=1.0, average_squared_distance=0.3, add_fixed_ones=True)
DEADLINE = 120.0  # seconds of one two-rank case, start-up included (about 4 s)


def _spawn(fn, args, tmp_path, **kw):
    return launch.spawn(fn, 2, args, backend="gloo", workdir=str(tmp_path / "ranks"), threads=2,
                        timeout=DEADLINE, **kw)


def _batches(N, nodes, G=2, seed=0):
    kw = dict(num_graphs=G, max_nodes=N, nodes_per_graph=nodes, max_bonds=2 * N, scale=0.35,
              seed=seed)
    return j_make_test_batch(**kw), make_test_batch(**kw, device="cpu")


def _setup(arch_kw=(), seed=0, N=12, nodes=None, G=2):
    """JAX's denoiser with its parameters perturbed by 0.3 (a nonzero output
    gain), and the port's E3Conv spec with the same weights."""
    arch_kw = dict(ARCH, **dict(arch_kw))
    jb, tb = _batches(N, nodes or [N - 3, N][:G] + [N - 1] * (G - 2), G, seed)
    jden = JDenoiser(JE3Conv(**arch_kw, use_pallas=False), JConfig(**CONFIG))
    params = jden.init(jax.random.PRNGKey(seed), jb)
    rng = np.random.default_rng(300 + seed)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )
    arch = E3Conv(**arch_kw, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    spec = dict(arch=arch_kw, state=arch.state_dict(), config=CONFIG, device="cpu")
    return jden, params, jb, tb, arch, spec


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path[1:]): np.asarray(v) for path, v in flat}


def _jax_mesh():
    return jmesh.make_mesh(2)


# ---- host-side helpers, exactly JAX's ----


@pytest.mark.parametrize("n_dev", [2, 4])
def test_partition_bonds_by_dst_equals_jax(n_dev):
    jb, tb = _batches(16, [13, 16])
    want = jas.partition_bonds_by_dst(jb.bond_src, jb.bond_dst, jb.bond_mask, n_dev, 16 // n_dev)
    got = pas.partition_bonds_by_dst(tb.bond_src, tb.bond_dst, tb.bond_mask, n_dev, 16 // n_dev)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _assert_batches_equal(tb, jb):
    for name in ("pos", "node_mask", "atom_type_index", "atom_code_index", "residue_code_index",
                 "residue_sequence_index", "bond_src", "bond_dst", "bond_mask", "loss_weight",
                 "graph_mask"):
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.shape == want.shape and np.array_equal(got, want.astype(got.dtype)), name
    for name in ("residue_atom_index", "residue_atom_mask", "residue_ca_index", "residue_mask",
                 "residue_codes"):
        assert (getattr(tb, name) is None) == (getattr(jb, name) is None), name


@pytest.mark.parametrize("G,multiple", [(3, 2), (4, 2), (5, 4)])
def test_pad_batch_to_multiple_equals_jax(G, multiple):
    jb, tb = _batches(10, None, G)
    got, want = pmesh.pad_batch_to_multiple(tb, multiple), jmesh.pad_batch_to_multiple(jb, multiple)
    _assert_batches_equal(got, want)
    assert got.pos.shape[0] % multiple == 0 and not got.graph_mask[G:].any()


@pytest.mark.parametrize("N,multiple", [(10, 4), (12, 4), (10, 3)])
def test_pad_atoms_to_multiple_equals_jax(N, multiple):
    jb, tb = _batches(N, [N - 2, N])
    _assert_batches_equal(pas.pad_atoms_to_multiple(tb, multiple), jas.pad_atoms_to_multiple(jb, multiple))


def test_prepare_atom_sharded_batch_equals_jax():
    jb, tb = _batches(14, [11, 13])
    jb, tb = jas.pad_atoms_to_multiple(jb, 2), pas.pad_atoms_to_multiple(tb, 2)
    want = jas.prepare_atom_sharded_batch(jb, _jax_mesh())
    got = pas.prepare_atom_sharded_batch(tb, pmesh.Mesh(size=2))
    _assert_batches_equal(got, want)
    with pytest.raises(ValueError, match="pad atoms to a multiple of 4"):
        pas.prepare_atom_sharded_batch(tb, pmesh.Mesh(size=4, rank=1))


@pytest.mark.parametrize("mode", [True, False, None, "true", "on", "false", "off", "auto", "banana"])
@pytest.mark.parametrize("n_atoms,n_devices", [(8, 8), (1024, 8), (1023, 8), (4096, 1)])
def test_resolve_atom_sharded_equals_jax(mode, n_atoms, n_devices):
    try:
        want = jas.resolve_atom_sharded(mode, n_atoms, 1024, n_devices)
    except ValueError:
        with pytest.raises(ValueError, match="want true/false/auto"):
            pas.resolve_atom_sharded(mode, n_atoms, 1024, n_devices)
        return
    assert pas.resolve_atom_sharded(mode, n_atoms, 1024, n_devices) is want


def test_single_process_helpers(monkeypatch):
    """Without a group: `initialize_distributed` is a no-op (no world size,
    or one), indices are 0, a mesh of one rank needs no group and a mesh of
    two raises; a graph-sharded generator draws its rows of the global
    draw, any other draw as the plain generator."""
    for var in ("WORLD_SIZE", "JAX_NUM_PROCESSES", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize_distributed() is False
    assert (distributed.rank(), distributed.world_size(), distributed.process_index()) == (0, 1, 0)
    assert not distributed.is_multihost()
    assert pmesh.make_mesh() == pmesh.make_mesh(1) == pmesh.Mesh()
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="needs this process's rank"):
        distributed.initialize_distributed(num_processes=2)

    plain = torch.Generator().manual_seed(5)
    full, after = torch.randn((6, 4, 3), generator=plain), torch.rand((), generator=plain)
    for rank in range(2):
        g = pmesh.GraphShardGenerator("cpu", rank, 2).manual_seed(5)
        assert torch.equal(pmesh.randn_graphs((3, 4, 3), g), full[3 * rank:3 * rank + 3])
        assert torch.equal(torch.rand((), generator=g), after)
    _, tb = _batches(8, None, 4)
    half = pmesh.shard_batch(tb, pmesh.Mesh(size=2, rank=1))
    assert torch.equal(half.pos, tb.pos[2:]) and torch.equal(half.graph_mask, tb.graph_mask[2:])
    with pytest.raises(ValueError, match="pad_batch_to_multiple first"):
        pmesh.shard_batch(tb, pmesh.Mesh(size=3))


# ---- two gloo ranks ----


def test_atom_sharded_pair_op_matches_jax_and_dense(tmp_path):
    """`atom_sharded_pair_op` (JAX's `test_atom_sharded_pair_op_exact`
    operation, 16 of 32 rows a rank) against JAX's on two devices and the
    dense product, and the gradients of sum(out^2) for the features and the
    positions (through the halo's reduce-scatter) against autograd of the
    dense product."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    pos = rng.standard_normal((32, 3)).astype(np.float32)
    mesh = _jax_mesh()

    def jax_pair(x_full, pos_full, dst_start, n_local):
        pos_dst = jax.lax.dynamic_slice_in_dim(pos_full, dst_start, n_local, axis=0)
        return jnp.exp(-jnp.sum((pos_dst[:, None] - pos_full[None]) ** 2, axis=-1)) @ x_full

    with mesh:
        want = np.asarray(jas.atom_sharded_pair_op(mesh, jax_pair)(
            jas.shard_atoms(jnp.asarray(x), mesh), jas.shard_atoms(jnp.asarray(pos), mesh)))
    tx, tpos = (torch.from_numpy(a).requires_grad_(True) for a in (x, pos))
    dense = launch.gaussian_pair_sum(tx, tpos, 0, 32)
    (dense ** 2).sum().backward()
    assert _rel(dense.detach(), want) < 1e-5
    for r in _spawn(launch.pair_op_worker, (dict(x=torch.from_numpy(x), pos=torch.from_numpy(pos)),),
                    tmp_path):
        assert _rel(r["out"], want) < 1e-5
        assert _rel(r["x_grad"], tx.grad) < 1e-5 and _rel(r["pos_grad"], tpos.grad) < 1e-5


@pytest.mark.parametrize("mode", ["dense", "nbr"])
def test_atom_sharded_forward_matches_jax_and_single_process(mode, tmp_path):
    """`atom_sharded_arch_apply` of E3Conv on two ranks (each its 6 of 12
    destination rows, the halo gathered per layer) against JAX's on two
    devices and the port's single-process forward; the gradients of
    sum(out^2), summed over the ranks, against the single process's."""
    kw = dict(neighbor_mode=mode, neighbor_cap=8)
    jden, params, jb, tb, arch, spec = _setup(kw)
    c_noise, cutoff = float(np.log(SIGMA) / 4), 1.2
    mesh = _jax_mesh()
    fwd = jax.jit(lambda p, b: jas.atom_sharded_forward(
        jden.arch, mesh, p, b, jnp.asarray([c_noise]), jnp.asarray(cutoff)))
    want = np.asarray(fwd(params, jas.prepare_atom_sharded_batch(jb, mesh)))
    ref = arch(tb, torch.tensor([c_noise]), cutoff)
    (ref ** 2).sum().backward()
    ref_grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                 for n, p in arch.named_parameters()}
    assert _rel(ref.detach(), want) < 1e-5
    spec = dict(spec, batch=launch.batch_spec(tb), c_noise=c_noise, cutoff=cutoff, grads=True)
    for r in _spawn(launch.forward_worker, (spec,), tmp_path):
        assert _rel(r["out"], want) < 1e-5 and _rel(r["out"], ref.detach()) < 1e-5
        live = [n for n, g in ref_grads.items() if np.abs(g).max() > 0]
        assert len(live) > 50
        for n in live:
            assert _rel(r["grads"][n], ref_grads[n]) < 1e-4, n


@pytest.mark.parametrize("mode", ["dense", "nbr"])
def test_atom_sharded_forward_in_one_process_matches_jax(mode):
    """`atom_sharded_arch_apply` over the mesh of one process (no group: the
    whole molecule, no collective) against JAX's `atom_sharded_forward` on a
    one-device mesh, and its gradients of sum(out^2) against the port's
    plain forward's."""
    jden, params, jb, tb, arch, _ = _setup(dict(neighbor_mode=mode, neighbor_cap=8))
    c_noise, cutoff = float(np.log(SIGMA) / 4), 1.2
    mesh = jmesh.make_mesh(1)
    want = np.asarray(jax.jit(lambda p, b: jas.atom_sharded_forward(
        jden.arch, mesh, p, b, jnp.asarray([c_noise]), jnp.asarray(cutoff)))(
        params, jas.prepare_atom_sharded_batch(jb, mesh)))
    grads = []
    for fwd in (lambda: pas.atom_sharded_arch_apply(arch, pmesh.Mesh(), tb, torch.tensor([c_noise]), cutoff),
                lambda: arch(tb, torch.tensor([c_noise]), cutoff)):
        arch.zero_grad(set_to_none=True)
        out = fwd()
        assert _rel(out.detach(), want) < 1e-5
        (out ** 2).sum().backward()
        grads.append({n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                      for n, p in arch.named_parameters()})
    live = [n for n, g in grads[1].items() if np.abs(g).max() > 0]
    assert len(live) > 50
    for n in live:
        assert _rel(grads[0][n], grads[1][n]) < 1e-4, n


def _params_close(got: dict, want: dict):
    """Each leaf within 1e-4 of its largest entry."""
    assert set(got) == set(want)
    for n, w in want.items():
        assert _rel(got[n], w) < 1e-4, (n, _rel(got[n], w))


def _jax_steps(jden, params, batches, mesh, steps, prep, opt):
    step = jax.jit(j_make_train_step(jden, opt, jdist.ConstantSigma(SIGMA), 0.999))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params),
                        ema_params=params, rng=jax.random.PRNGKey(0))
    state = jax.device_put(state, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    logged = []
    for i in range(steps):
        state, aux = step(state, prep(batches[i % len(batches)]))
        logged.append((float(aux["loss"]), float(aux["grad_norm"])))
    return _flat(state.params), logged


def _fit_spec(spec, batches, atom_sharded, steps, optimizer):
    return dict(spec, train=[launch.batch_spec(b) for b in batches], optimizer=optimizer, sigma=SIGMA,
                trainer=dict(max_steps=steps, log_every_n_steps=1, atom_sharded=atom_sharded,
                             collect_sigma_diagnostics=False))


def _logged(metrics):
    """(loss, grad_norm) of every logged step."""
    return [(m["train/loss"], m["train/grad_norm"]) for _, m in metrics if "train/loss" in m]


def _same_steps(got, *wants):
    """Losses and gradient norms of every step within 1e-5 relative."""
    for want in wants:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(a, b)), (a, b)


def test_atom_sharded_train_step_matches_single_process_and_jax(tmp_path):
    """One `Trainer.fit` step, atom sharded over two ranks (N = 12, two
    graphs of 9 and 12 atoms): loss and parameters against the
    single-process fit and JAX's `test_atom_sharded_train_step_parity` setup
    (`denoiser_with_atom_sharding`, optax.adam(1e-3), two devices)."""
    jden, params, jb, tb, arch, spec = _setup()
    mesh = _jax_mesh()
    jparams, jlosses = _jax_steps(
        jas.denoiser_with_atom_sharding(jden, mesh), params, [jb], mesh, 1,
        lambda b: jas.prepare_atom_sharded_batch(jas.pad_atoms_to_multiple(b, 2), mesh),
        optax.adam(1e-3),
    )
    fit = _fit_spec(spec, [tb], True, 1, ("adam", dict(learning_rate=1e-3)))
    single = launch.fit_worker(0, 1, dict(fit, trainer=dict(fit["trainer"], atom_sharded=False)))
    ranks = _spawn(launch.fit_worker, (fit,), tmp_path)
    got = ranks[0]
    assert got["steps"] == 1 and ranks[1]["metrics"] == []  # rank 0 alone logs
    _same_steps(_logged(got["metrics"]), jlosses, _logged(single["metrics"]))
    _params_close({n: p.numpy() for n, p in got["params"].items()}, jparams)
    _params_close(got["params"], single["params"])
    for n in got["params"]:  # the ranks' updates are the same
        assert torch.equal(got["params"][n], ranks[1]["params"][n]), n


def test_data_parallel_train_steps_match_jax_with_a_dummy_graph(tmp_path):
    """Two `Trainer.fit` steps, data parallel over two ranks, on batches of
    three graphs (padded to four: a masked dummy graph on rank 1): the
    global loss and the parameters against the single-process fit on the
    three graphs and JAX's steps on a two-device mesh (`shard_batch` of the
    padded batch), the global gradient norm of each step too. SGD, as JAX's
    own `test_dp_train_step_parity`: under Adam an entry whose gradient is
    at the level of f32 rounding (some rows of the residue-code table here)
    moves by a step of either sign (measured: 5.2e-4 after two Adam steps at
    lr 1e-3, the single-process port against JAX alike)."""
    jden, params, _, _, arch, spec = _setup(G=3)
    pairs = [_batches(12, [9, 12, 11], 3, seed) for seed in (0, 1)]
    mesh = _jax_mesh()
    jparams, jlosses = _jax_steps(
        jden, params, [j for j, _ in pairs], mesh, 2,
        lambda b: jmesh.shard_batch(jmesh.pad_batch_to_multiple(b, 2), mesh), optax.sgd(1e-2),
    )
    fit = _fit_spec(spec, [t for _, t in pairs], False, 2, ("sgd", dict(learning_rate=1e-2)))
    single = launch.fit_worker(0, 1, fit)
    ranks = _spawn(launch.fit_worker, (fit,), tmp_path)
    got = ranks[0]
    _same_steps(_logged(got["metrics"]), jlosses, _logged(single["metrics"]))
    _params_close({n: p.numpy() for n, p in got["params"].items()}, jparams)
    _params_close(got["params"], single["params"])
    _params_close(got["ema"], single["ema"])
    for n in got["params"]:
        assert torch.equal(got["params"][n], ranks[1]["params"][n]), n


def test_sharded_samplers_match_the_plain_sampler(tmp_path):
    """`Sampler(num_devices=2)` (two chains per rank, its rows of every
    draw) and `Sampler(atom_sharded=True)` (each rank 6 of 12 atoms), two
    continued batches of 5 BAOAB steps, against the plain `Sampler`: every
    rank returns every graph's samples. Initial weights (seed 0, output gain
    1), as JAX's `test_atom_sharded_sampler_parity` takes them: with the
    weights perturbed by 0.3 the walk itself amplifies the f32 rounding of
    a differently batched forward (about 1e-5 of the score) to 1.9e-4 of
    the last velocity's largest entry in ten steps (measured)."""
    _, _, _, tb, _, spec = _setup(G=4, nodes=[9, 12, 11, 12])
    arch = E3Conv(**ARCH, device="cpu", seed=0)
    with torch.no_grad():
        arch.output_gain.fill_(1.0)
    spec = dict(spec, state=arch.state_dict(), batch=launch.batch_spec(tb), sigma=SIGMA,
                num_batches=2, mcmc=dict(delta=0.04, friction=1.0, M=1.0, steps=5,
                                         save_every_n_steps=1, score_fn_clip=100.0))
    plain = launch.sample_worker(0, 1, spec)["samples"]
    plan = [(launch.sample_worker, spec), (launch.sample_worker, dict(spec, atom_sharded=True))]
    for rank_results in _spawn(launch.run_plan, (plan,), tmp_path):
        for res in rank_results:
            got = res["samples"]
            assert [len(b) for b in got] == [4, 4]
            for bg, bw in zip(got, plain):
                for g, w in zip(bg, bw):
                    assert g["num_atoms"] == w["num_atoms"] and g["graph_index"] == w["graph_index"]
                    for k, v in w.items():
                        if isinstance(v, np.ndarray):
                            assert _rel(g[k], v) < 1e-4, k


@pytest.fixture()
def synthetic_data(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_synthetic_data import make_molecule, make_trajectory

    from jamun_tpu.data.topology import save_pdb

    out = tmp_path / "data" / "synthetic" / "train"
    out.mkdir(parents=True)
    for i, code in enumerate(["AG", "SV"]):
        top, pos0 = make_molecule(2, seed=i)
        save_pdb(str(out / f"{code}-traj-state0.pdb"), top, pos0)
        np.savez(out / f"{code}-traj-arrays.npz", positions=make_trajectory(pos0, 32, seed=100 + i))
    return str(tmp_path / "data")


def test_train_cli_on_two_ranks_writes_from_rank_zero(tmp_path, synthetic_data):
    """`cmdline.train experiment=train_test parallel.num_devices=2` on two
    ranks, each in its own working directory: both run the 4 steps, rank 0
    writes the whole run directory and rank 1 writes nothing."""
    cwds = [tmp_path / "rank0", tmp_path / "rank1"]
    for d in cwds:
        d.mkdir()
    argv = ["--experiment-dir", os.path.join(REPO, "configs", "experiment"), "experiment=train_test",
            "device=cpu", "parallel.num_devices=2", "trainer.max_steps=4",
            "trainer.val_every_n_steps=2", "trainer.log_every_n_steps=2", "trainer.val_max_batches=1"]
    r0, r1 = _spawn(launch.train_cli_worker, (argv,), tmp_path, cwds=[str(d) for d in cwds],
                    env={"JAMUN_DATA_PATH": synthetic_data})
    assert r0["step"] == r1["step"] == 4
    assert r1["files"] == []
    for f in ("config.pkl", "config.yaml", "metrics.csv", "checkpoints/last.ckpt",
              "checkpoints/step4.ckpt", "checkpoints/manifest.json"):
        assert os.path.join("runs", "test", f) in r0["files"], f
