"""The port's train CLI against JAX's (CPU): `experiment=train_test` on the
repo's synthetic dataset writes the same run directory (file names, manifest
keys, CSV header), trains to a finite loss, and resumes from the saved
step; and the first batch the port's DataModule yields, through the port's
train step from JAX's initial parameters (noise of ones on both sides),
gives JAX's loss within 1e-5 relative (f32 summation order), and so does
the second step, after one update of each side's optimizer."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from jamun_tpu.cmdline import common as jcommon
from jamun_tpu.cmdline import train as jtrain
from jamun_tpu.config.compose import compose as j_compose
from jamun_tpu.config.instantiate import instantiate as j_instantiate
from jamun_tpu.data.datamodule import DataModule as JDataModule
from jamun_tpu.data.topology import save_pdb
from jamun_tpu.train.state import create_train_state as j_create_train_state
from jamun_tpu.train.state import make_train_step as j_make_train_step
from jamun_tpu_torch.cmdline import common
from jamun_tpu_torch.cmdline import train
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.data.datamodule import DataModule
from jamun_tpu_torch.models import e3conv as e3conv_mod
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.train.state import create_train_state, make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from make_synthetic_data import make_molecule, make_trajectory  # noqa: E402

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
EXP_DIR = os.path.join(REPO, "configs", "experiment")
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
        save_pdb(str(out / f"{code}-traj-state0.pdb"), top, pos0)
        np.savez(out / f"{code}-traj-arrays.npz", positions=make_trajectory(pos0, 64, seed=100 + i))
    return str(root)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _csv_header(path):
    with open(path) as f:
        return f.readline().strip().split(",")


def test_train_cli_writes_jax_run_directory_and_resumes(data_path, tmp_path, monkeypatch):
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    jtrain.main(["--experiment-dir", EXP_DIR, "experiment=train_test", *SHORT])
    monkeypatch.chdir(port_dir)
    state = train.main(["--experiment-dir", EXP_DIR, "experiment=train_test", "device=cpu", *SHORT])
    assert state.step == 4 and next(state.module.parameters()).device.type == "cpu"

    want, got = _tree(jax_dir / "runs" / "test"), _tree(port_dir / "runs" / "test")
    assert got == want, (got, want)
    assert {"config.pkl", "config.yaml", "metrics.csv", "checkpoints/last.ckpt",
            "checkpoints/manifest.json", "checkpoints/step2.ckpt", "checkpoints/step4.ckpt",
            "diagnostics/sigma_distribution_epoch0.csv"} <= set(got)
    manifests = [json.loads((d / "runs" / "test" / "checkpoints" / "manifest.json").read_text())
                 for d in (jax_dir, port_dir)]
    assert sorted(manifests[0]) == sorted(manifests[1])
    assert [sorted(e) for e in manifests[0]["entries"]] == [sorted(e) for e in manifests[1]["entries"]]
    steps = [sorted(e["step"] for e in m["entries"]) for m in manifests]
    assert steps[0] == steps[1] == [2, 4]
    header = _csv_header(port_dir / "runs" / "test" / "metrics.csv")
    assert header == _csv_header(jax_dir / "runs" / "test" / "metrics.csv")
    with open(port_dir / "runs" / "test" / "metrics.csv") as f:
        rows = [dict(zip(header, line.strip().split(","))) for line in list(f)[1:]]
    losses = [float(r["train/loss"]) for r in rows if r["train/loss"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert np.isfinite(float(manifests[1]["entries"][0]["val/loss"]))

    # resume: the step carries on from the saved one
    ckpt = str(port_dir / "runs" / "test" / "checkpoints" / "last.ckpt")
    resumed = train.main(["--experiment-dir", EXP_DIR, "experiment=train_test", "device=cpu", *SHORT,
                          "trainer.max_steps=6", f"resume_from_checkpoint={ckpt}"])
    assert resumed.step == 6
    manifest = json.loads((port_dir / "runs" / "test" / "checkpoints" / "manifest.json").read_text())
    assert sorted(e["step"] for e in manifest["entries"]) == [2, 4, 6]
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 6
    for n, p in resumed.module.state_dict().items():
        assert torch.equal(saved["params"][n], p), n


def test_first_batch_loss_matches_jax(data_path, monkeypatch):
    """The composed train_test config on both sides, `add_fixed_ones`: the
    same first batch, and the port's train step from JAX's initial
    parameters gives JAX's train-step loss. The initial output gain is 0, so
    the first loss sees no network output; the second step's does."""
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    ovs = ["experiment=train_test", "model.add_fixed_ones=true"]
    cfg = compose(train.DEFAULT_CONFIG_DIR, "train", ovs, EXP_DIR)
    jcfg = j_compose(jtrain.DEFAULT_CONFIG_DIR, "train", ovs, EXP_DIR)
    dm_kw = {k: v for k, v in cfg["data"]["datamodule"].items() if k != "_target_"}
    batch = next(iter(DataModule(datasets=instantiate(cfg["data"]["datasets"]), **dm_kw).train_batches(0)))
    jbatch = next(iter(JDataModule(datasets=j_instantiate(jcfg["data"]["datasets"]), **dm_kw,
                                   prefetch=0).train_batches(0)))
    for name in ("pos", "node_mask", "atom_type_index", "bond_src", "bond_mask", "graph_mask"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)))

    asd = 0.15
    jden = jcommon.build_denoiser(jcfg["model"], asd)
    jopt = jcommon.build_optimizer(jcfg["model"])
    jstate = j_create_train_state(jden, jopt, jbatch, seed=0)
    jstep = jax.jit(j_make_train_step(jden, jopt, j_instantiate(jcfg["model"]["sigma"])))
    jstate2, jaux = jstep(jstate, jbatch)
    _, jaux2 = jstep(jstate2, jbatch)

    den = common.build_denoiser(cfg["model"], asd, device="cpu", seed=0)
    assert den.arch.tensor_product == "uvw" and den.config.add_fixed_ones
    den.arch.load_state_dict(from_jax_params(jstate.params), strict=True)
    state = create_train_state(den, common.build_optimizer(cfg["model"]), device="cpu")
    step = make_train_step(den, instantiate(cfg["model"]["sigma"]))
    _, aux = step(state, batch.to_device("cpu"))
    assert abs(float(aux["loss"]) - float(jaux["loss"])) <= 1e-5 * abs(float(jaux["loss"]))
    assert float(aux["sigma"]) == float(jaux["sigma"])
    _, aux2 = step(state, batch.to_device("cpu"))
    assert float(jaux2["loss"]) != float(jaux["loss"])
    assert abs(float(aux2["loss"]) - float(jaux2["loss"])) <= 1e-5 * abs(float(jaux2["loss"]))


def test_equivariance_self_test(data_path, monkeypatch):
    """`model.test_equivariance`: the uvw arch of train_test on its first
    training batch passes the runtime self-test (f32: below 1e-4), and
    fails it with its edge harmonics broken (two l=1 components swapped)."""
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    cfg = compose(train.DEFAULT_CONFIG_DIR, "train", ["experiment=train_test"], EXP_DIR)
    dm_kw = {k: v for k, v in cfg["data"]["datamodule"].items() if k != "_target_"}
    dm = DataModule(datasets=instantiate(cfg["data"]["datasets"]), **dm_kw)
    den = common.build_denoiser(cfg["model"], 0.15, device="cpu", seed=0)
    assert train.equivariance_self_test(den, dm, "cpu") < 1e-4
    sh = e3conv_mod.spherical_harmonics
    monkeypatch.setattr(e3conv_mod, "spherical_harmonics", lambda *a, **k: sh(*a, **k)[..., [0, 2, 1, 3]])
    with pytest.raises(AssertionError, match="not equivariant"):
        train.equivariance_self_test(den, dm, "cpu")
