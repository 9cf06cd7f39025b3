"""The port's Ophiuchus against JAX's (CPU, f32): the residue layout that
`collate` builds, `tensor_square`, `SelfInteraction` and the whole arch from
carried JAX parameters (also with the sequence-index embedding), the
training loss's gradients, E(3) equivariance, the Denoiser's score, a JAX
train state restored from JAX's flax-msgpack checkpoint, and the train and
sample CLIs on `train_test model/arch=ophiuchus`.

Width `8x0e + 8x1e`, 2 layers, `mul_factor` 8 (the repo's own Ophiuchus
tests' size). Batches: three alanines in two copies (`tests/test_ophiuchus.py`'s
`_peptide_batch`), and a ragged one of that chain and the tetrapeptide KWFE
(`build_peptide`, four residues of 9-14 heavy atoms) with a dummy graph.
Parameters: JAX's `init`, every leaf moved by seeded noise so that no
noise-conditional layer sits at its identity start. Each tolerance is
written beside its check.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamun_tpu.cmdline import common as jcommon
from jamun_tpu.cmdline import train as jtrain
from jamun_tpu.config.compose import compose as j_compose
from jamun_tpu.config.instantiate import instantiate as j_instantiate
from jamun_tpu.data import batching as jbatching
from jamun_tpu.data import peptide_builder as jpeptides
from jamun_tpu.data import topology as jtopology
from jamun_tpu.data.datamodule import DataModule as JDataModule
from jamun_tpu.models.denoiser import Denoiser as JDenoiser, DenoiserConfig as JConfig
from jamun_tpu.models.ophiuchus import Ophiuchus as JOphiuchus
from jamun_tpu.models.ophiuchus import SelfInteraction as JSelfInteraction
from jamun_tpu.models.ophiuchus import tensor_square as j_tensor_square
from jamun_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from jamun_tpu.train.state import TrainState as JTrainState
from jamun_tpu.train.state import create_train_state as j_create_train_state
from jamun_tpu.train.state import make_train_step as j_make_train_step
from jamun_tpu_torch.cmdline import common, sample, train
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.data import batching, peptide_builder, topology
from jamun_tpu_torch.data.datamodule import DataModule
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from jamun_tpu_torch.models.ophiuchus import Ophiuchus, SelfInteraction, tensor_square
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.ops.irreps import Irreps
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.train.checkpoints import restore_checkpoint
from jamun_tpu_torch.train.optim import adam
from jamun_tpu_torch.train.state import create_train_state, make_train_step
from jamun_tpu_torch.utils.equivariance import random_rotation

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from make_synthetic_data import make_molecule, make_trajectory  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
EXP_DIR = os.path.join(REPO, "configs", "experiment")
SIGMA = 0.04
ARCH = dict(irreps_hidden="8x0e + 8x1e", n_layers=2, mul_factor=8, edge_attr_dim=8,
            residue_code_embedding_dim=8)
CONFIG = dict(max_radius=1.0, average_squared_distance=0.3)
RESIDUE_FIELDS = ("residue_atom_index", "residue_atom_mask", "residue_ca_index", "residue_mask",
                  "residue_codes")


def _alanines(mod, n_res: int):
    """`_peptide_batch`'s chain of `n_res` alanine backbones (N, CA, C, O),
    through the topology module `mod` (JAX's or the port's)."""
    atoms, pos = [], []
    for r in range(n_res):
        for nm, el in zip(["N", "CA", "C", "O"], ["N", "C", "C", "O"]):
            atoms.append(mod.Atom(index=len(atoms), name=nm, element=el, residue_name="ALA",
                                  residue_index=r, residue_seq=r + 1))
            pos.append([0.12 * len(pos), 0.05 * r, 0.02 * len(pos) % 0.3])
    pos = np.asarray(pos, np.float32)
    pos = pos + np.random.default_rng(0).standard_normal(pos.shape).astype(np.float32) * 0.01
    return mod.preprocess_topology(mod.Topology(atoms=atoms, bonds=[]), pos)[0], pos


def _items(which: str, side: str):
    """(items, bucket spec, num_graphs) of a test batch on one side."""
    topo, bat, peptides = ((jtopology, jbatching, jpeptides) if side == "jax"
                          else (topology, batching, peptide_builder))
    ala = _alanines(topo, 3)
    if which == "peptide":
        return [ala, ala], bat.BucketSpec(node_buckets=(16,)), None
    top, pos = peptides.build_peptide("KWFE")
    kwfe = topo.preprocess_topology(top, pos)[0], pos.astype(np.float32)
    return [ala, kwfe], bat.BucketSpec(), 3


def _jax_batch(which: str):
    items, spec, G = _items(which, "jax")
    return jbatching.collate(items, spec, num_graphs=G)


def _port(jb) -> GraphBatch:
    """JAX's batch as the port's (int64 indices, bool masks)."""
    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x.copy())

    return GraphBatch(**{f.name: t(getattr(jb, f.name)) for f in dataclasses.fields(GraphBatch)})


def _perturbed(params, seed: int, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params,
    )


def _c_noise():
    return float(np.log(SIGMA) / 4.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("which", ["peptide", "ragged"])
def test_residue_layout_equals_jax(which):
    """`collate`'s five residue fields, built on each side from its own
    templates: equal to JAX's exactly (dummy graphs: zero rows)."""
    items, spec, G = _items(which, "port")
    got = batching.collate(items, spec, num_graphs=G)
    want = _jax_batch(which)
    for name in RESIDUE_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == (np.int64 if w.dtype == np.int32 else w.dtype), name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if G:
        assert not got.residue_mask[2].any() and not got.residue_atom_index[2].any()
    assert batching.collate(items, dataclasses.replace(spec, with_residue_layout=False),
                            num_graphs=G).residue_atom_index is None


@pytest.mark.parametrize("irreps", ["1x0e + 1x1e", "2x0e + 3x1e", "1x0e + 2x1e + 1x2e"])
def test_tensor_square_equals_jax(irreps):
    """The same output irreps; values within 1e-6 of the max."""
    x = np.random.default_rng(0).standard_normal((5, Irreps(irreps).dim)).astype(np.float32)
    got, irreps_out = tensor_square(torch.from_numpy(x), irreps)
    want, j_irreps_out = j_tensor_square(jnp.asarray(x), irreps)
    assert str(irreps_out) == str(j_irreps_out)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("irreps,mul_factor", [("8x0e + 8x1e", 8), ("16x0e + 8x1e", 4),
                                               ("64x0e + 64x1e", 64)])
def test_self_interaction_equals_jax(irreps, mul_factor):
    """From JAX's parameters (perturbed): within 1e-4 of the max."""
    D = Irreps(irreps).dim
    x = np.random.default_rng(1).standard_normal((3, 5, D)).astype(np.float32)
    c = jnp.asarray([_c_noise()])
    module = JSelfInteraction(irreps, mul_factor)
    params = _perturbed(module.init(jax.random.PRNGKey(0), jnp.asarray(x), c), 2)
    want = module.apply(params, jnp.asarray(x), c)
    port = SelfInteraction(irreps, mul_factor)
    port.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.tensor([_c_noise()]))
    assert _rel(got.numpy(), want) <= 1e-4
    with pytest.raises(ValueError, match="must divide"):
        SelfInteraction(irreps, 3)


def _models(which: str, seq_index: bool):
    jb = _jax_batch(which)
    jarch = JOphiuchus(**ARCH, use_residue_sequence_index=seq_index)
    c = jnp.asarray([_c_noise()])
    params = _perturbed(jarch.init(jax.random.PRNGKey(0), jb, c, 1.0), 3)
    arch = Ophiuchus(**ARCH, use_residue_sequence_index=seq_index, device="cpu")
    arch.load_state_dict(from_jax_params(params), strict=True)
    return jarch, params, jb, arch, _port(jb)


@pytest.mark.parametrize("seq_index", [False, True])
@pytest.mark.parametrize("which", ["peptide", "ragged"])
def test_ophiuchus_equals_jax(which, seq_index):
    """The arch's output from carried parameters: within 1e-4 of the max;
    zero on padded atoms and dummy graphs; a parameter count equal to
    JAX's."""
    jarch, params, jb, arch, tb = _models(which, seq_index)
    cutoff = 0.8
    want = np.asarray(jax.jit(jarch.apply)(params, jb, jnp.asarray([_c_noise()]), cutoff))
    with torch.no_grad():
        got = arch(tb, torch.tensor([_c_noise()]), cutoff).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert np.all(got[~tb.node_mask.numpy()] == 0.0)
    assert sum(p.numel() for p in arch.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(params))


def test_ophiuchus_is_e3_equivariant():
    """A rotation and a shift of the positions rotate the output (the head
    predicts displacements: no shift): 1e-4 of the max."""
    _, _, _, arch, tb = _models("ragged", False)
    R = torch.from_numpy(random_rotation(np.random.default_rng(4)).astype(np.float32))
    perm = [1, 2, 0]
    D1 = R[perm][:, perm]
    c = torch.tensor([_c_noise()])
    mask = tb.node_mask[..., None].float()
    with torch.no_grad():
        out = arch(tb, c, 0.8)
        moved = arch(tb.replace_pos((tb.pos @ R.T + torch.tensor([0.3, -0.2, 0.5])) * mask), c, 0.8)
    assert float((moved - out @ D1.T).abs().max() / out.abs().max()) <= 1e-4


def _denoisers(which: str, seq_index: bool, **config):
    jarch, params, jb, arch, tb = _models(which, seq_index)
    return (JDenoiser(jarch, JConfig(**CONFIG, **config)), params, jb,
            Denoiser(arch, DenoiserConfig(**CONFIG, **config)), tb)


def test_denoiser_score_equals_jax():
    """`Denoiser.score` with Ophiuchus (an arch that takes no Verlet list
    and reports no telemetry): within 1e-4 of the max."""
    jden, params, jb, den, tb = _denoisers("ragged", False)
    want = np.asarray(jax.jit(jden.score)(params, jb, SIGMA))
    with torch.no_grad():
        got = den.score(tb, SIGMA).numpy()
        _, tel = den.xhat(tb, SIGMA, with_telemetry=True)
    assert _rel(got, want) <= 1e-4
    assert tel == {}
    assert not den.sparse_neighbors_active(4096) and den.neighbor_cap == 32
    assert den.make_neighbor_cached_score(tb, SIGMA, skin=1.0) is None


@pytest.mark.parametrize("seq_index", [False, True])
def test_training_loss_gradients_equal_jax(seq_index):
    """`training_loss` (noise of ones on both sides) against JAX's
    `value_and_grad`: the loss within 1e-5 relative, every gradient within
    1e-4 of its leaf's max (a table the batch does not index: zero)."""
    jden, params, jb, den, tb = _denoisers("ragged", seq_index, add_fixed_ones=True)
    (jloss, _), jgrads = jax.value_and_grad(jden.training_loss, has_aux=True)(
        params, jax.random.PRNGKey(0), jb, SIGMA)
    loss, _ = den.training_loss(tb, SIGMA, torch.Generator())
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = {k: v.numpy() for k, v in from_jax_params(jgrads).items()}
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in den.arch.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        if np.abs(ref).max() == 0:
            assert np.abs(got[name]).max() == 0, name
        else:
            assert _rel(got[name], ref) <= 1e-4, (name, _rel(got[name], ref))


def test_jax_train_state_restores_and_scores_bit_for_bit(tmp_path):
    """A JAX Ophiuchus train state (Adam, one update on seeded gradients,
    EMA moved off the parameters) written by JAX's `save_checkpoint`
    (flax-msgpack) restores through `restore_checkpoint`: the EMA score
    equals, bit for bit, the score of the EMA parameters carried directly,
    and Adam's moments and count are JAX's."""
    jden, _, jb, den, tb = _denoisers("ragged", False)
    opt = optax.adam(2e-3)
    jstate = j_create_train_state(jden, opt, jb, seed=0)
    rng = np.random.default_rng(5)
    params = _perturbed(jstate.params, 6)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(np.shape(p)).astype(np.float32)), params)
    updates, opt_state = opt.update(grads, opt.init(params), params)
    params = optax.apply_updates(params, updates)
    ema = _perturbed(params, 7, 0.05)
    path = str(tmp_path / "last.ckpt")
    j_save_checkpoint(path, JTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                                        opt_state=opt_state, ema_params=ema, rng=jstate.rng))

    arch = Ophiuchus(**ARCH, device="cpu", seed=1)
    state = create_train_state(Denoiser(arch, den.config), adam(2e-3), seed=1, device="cpu")
    restore_checkpoint(path, state)
    assert state.step == 3 and state.optimizer.param_groups[0]["count"] == 1
    for key in ("mu", "nu"):  # Adam's state, placed by name
        want = from_jax_params(getattr(opt_state[0], key))
        for name, p in state.module.named_parameters():
            assert torch.equal(state.optimizer.state[p][key], want[name]), (key, name)
    direct = Ophiuchus(**ARCH, device="cpu")
    direct.load_state_dict(from_jax_params(ema), strict=True)
    with torch.no_grad():
        restored = Denoiser(state.ema, den.config).score(tb, SIGMA)
        carried = Denoiser(direct, den.config).score(tb, SIGMA)
    assert torch.isfinite(restored).all()
    assert torch.equal(restored.view(torch.int32), carried.view(torch.int32))


# ---- the CLIs ----

OPH = ["model/arch=ophiuchus", "model.arch.irreps_hidden=16x0e + 8x1e", "model.arch.mul_factor=8"]
SHORT = ["trainer.max_steps=4", "trainer.val_every_n_steps=2", "trainer.log_every_n_steps=2",
         "trainer.val_max_batches=1"]


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    """`scripts/make_synthetic_data.py`'s AG and SV molecules, 64 frames each."""
    root = tmp_path_factory.mktemp("data")
    out = root / "synthetic" / "train"
    out.mkdir(parents=True)
    for i, code in enumerate(["AG", "SV"]):
        top, pos0 = make_molecule(2, seed=i)
        jtopology.save_pdb(str(out / f"{code}-traj-state0.pdb"), top, pos0)
        np.savez(out / f"{code}-traj-arrays.npz", positions=make_trajectory(pos0, 64, seed=100 + i))
    return str(root)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_train_and_sample_cli(data_path, tmp_path, monkeypatch):
    """`train_test model/arch=ophiuchus` (the config's mul_factor 64 does
    not divide train_test's widths: 8) writes JAX's run directory and
    resumes; the sample CLI samples from that run (files, finite metrics)."""
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    jtrain.main(["--experiment-dir", EXP_DIR, "experiment=train_test", *OPH, *SHORT])
    monkeypatch.chdir(port_dir)
    state = train.main(["--experiment-dir", EXP_DIR, "experiment=train_test", "device=cpu", *OPH,
                        *SHORT, "model.test_equivariance=true"])
    assert state.step == 4 and isinstance(state.module, Ophiuchus)
    assert _tree(port_dir / "runs" / "test") == _tree(jax_dir / "runs" / "test")
    manifest = json.loads((port_dir / "runs" / "test" / "checkpoints" / "manifest.json").read_text())
    assert sorted(e["step"] for e in manifest["entries"]) == [2, 4]

    res = sample.main(["--experiment-dir", EXP_DIR, "experiment=sample_test", "device=cpu",
                       "num_sampling_steps_per_batch=6", "save_every_n_steps=1", "num_batches=2"])
    assert isinstance(res["denoiser"].arch, Ophiuchus)
    for label in ("AG", "SV"):
        r = res["results"][label]
        assert r["num_frames"] == 2 * 6 and np.isfinite(r["ramachandran_jsd"])
        base = port_dir / "runs" / "test" / "sampler" / label / "predicted_samples"
        assert sorted(p.name for p in base.glob("batch_*.npy")) == [
            "batch_0_graph_0.npy" if label == "AG" else "batch_0_graph_1.npy",
            "batch_1_graph_0.npy" if label == "AG" else "batch_1_graph_1.npy"]
    assert os.path.exists(port_dir / "runs" / "test" / "sampler" / "sampling_times.csv")


def test_first_two_losses_equal_jax(data_path, monkeypatch):
    """The composed config on both sides with `add_fixed_ones`: the same
    first batch, and the port's train step from JAX's initial parameters
    gives JAX's first two losses within 1e-5 relative."""
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    ovs = ["experiment=train_test", *OPH, "model.add_fixed_ones=true"]
    cfg = compose(train.DEFAULT_CONFIG_DIR, "train", ovs, EXP_DIR)
    jcfg = j_compose(jtrain.DEFAULT_CONFIG_DIR, "train", ovs, EXP_DIR)
    dm_kw = {k: v for k, v in cfg["data"]["datamodule"].items() if k != "_target_"}
    batch = next(iter(DataModule(datasets=instantiate(cfg["data"]["datasets"]), **dm_kw).train_batches(0)))
    jbatch = next(iter(JDataModule(datasets=j_instantiate(jcfg["data"]["datasets"]), **dm_kw,
                                   prefetch=0).train_batches(0)))
    for name in ("pos", "node_mask", *RESIDUE_FIELDS):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)))

    asd = 0.15
    jden = jcommon.build_denoiser(jcfg["model"], asd)
    jopt = jcommon.build_optimizer(jcfg["model"])
    jstate = j_create_train_state(jden, jopt, jbatch, seed=0)
    jstep = jax.jit(j_make_train_step(jden, jopt, j_instantiate(jcfg["model"]["sigma"])))
    jstate2, jaux = jstep(jstate, jbatch)
    _, jaux2 = jstep(jstate2, jbatch)

    den = common.build_denoiser(cfg["model"], asd, device="cpu", seed=0)
    assert isinstance(den.arch, Ophiuchus) and den.arch.tensor_product == "uvw"
    den.arch.load_state_dict(from_jax_params(jstate.params), strict=True)
    state = create_train_state(den, common.build_optimizer(cfg["model"]), device="cpu")
    step = make_train_step(den, instantiate(cfg["model"]["sigma"]))
    for want in (jaux, jaux2):
        _, aux = step(state, batch.to_device("cpu"))
        assert abs(float(aux["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    assert float(jaux2["loss"]) != float(jaux["loss"])
