"""The port's sample CLI (CPU): the kernel-default rule against JAX's table,
the starting frames against JAX's `get_initial_graphs`, and the whole CLI
with `device=cpu` on a run directory of the port's train CLI
(`experiment=train_test`, 4 steps, then `experiment=sample_test` with 20
steps and 2 batches): JAX's sampler layout, the sampling-time CSV, the EMA
weights restored, and `finetune_on_init` moving the EMA parameters. The same
CLI on a run directory that JAX's train CLI wrote, against JAX's own sample
CLI, is `tests/test_torch_sample_cli_jax.py`."""

import copy
import csv
import os
import sys

import numpy as np
import pytest
import torch

from jamun_tpu.cmdline.sample import apply_arch_kernel_defaults as j_apply
from jamun_tpu.cmdline.sample import get_initial_graphs as j_initial_graphs
from jamun_tpu.data.discovery import parse_datasets_from_directory as j_parse
from jamun_tpu.data.topology import save_pdb
from jamun_tpu_torch.analysis.load_trajectory import get_sampling_rate, list_run_labels, load_run_trajectory
from jamun_tpu_torch.cmdline import sample, train
from jamun_tpu_torch.data.discovery import parse_datasets_from_directory as t_parse

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from make_synthetic_data import make_molecule, make_trajectory  # noqa: E402

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
EXP_DIR = os.path.join(REPO, "configs", "experiment")
TRAIN = ["experiment=train_test", "trainer.max_steps=4", "trainer.val_every_n_steps=2",
         "trainer.log_every_n_steps=2", "trainer.val_max_batches=1"]
SAMPLE = ["experiment=sample_test", "num_sampling_steps_per_batch=20", "num_batches=2",
          "save_every_n_steps=5"]
CODES = ("AG", "SV")
PATTERNS = ("^(.*)-traj-arrays.npz", "^(.*)-traj-state0.pdb")


def write_synthetic_data(root) -> str:
    """`scripts/make_synthetic_data.py`'s AG and SV molecules, 64 frames
    each, in `<root>/synthetic/train`; returns that directory."""
    out = root / "synthetic" / "train"
    out.mkdir(parents=True)
    for i, code in enumerate(CODES):
        top, pos0 = make_molecule(2, seed=i)
        save_pdb(str(out / f"{code}-traj-state0.pdb"), top, pos0)
        np.savez(out / f"{code}-traj-arrays.npz", positions=make_trajectory(pos0, 64, seed=100 + i))
    return str(out)


def sampler_layout(graphs_per_label, num_batches: int):
    """The files JAX's sample CLI writes under `output_dir`: per label and
    sampled graph `batch_<k>_graph_<g>.{dcd,npy,pdb}` (k counts that label's
    updates), the joined trajectory and topology, the HTML viewer; then the
    CSV."""
    files = ["sampling_times.csv"]
    for label, graphs in graphs_per_label.items():
        base = os.path.join(label, "predicted_samples")
        k = 0
        for _ in range(num_batches):
            for g in graphs:
                files += [os.path.join(base, f"batch_{k}_graph_{g}.{ext}") for ext in ("dcd", "npy", "pdb")]
                k += 1
        files += [os.path.join(base, "joined_trajectory.dcd"), os.path.join(base, "topology.pdb"),
                  os.path.join(label, "samples.html")]
    return sorted(files)


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's train CLI on the synthetic data: (work dir, data path)."""
    root = tmp_path_factory.mktemp("port_run")
    write_synthetic_data(root / "data")
    cwd, env = os.getcwd(), os.environ.get("JAMUN_DATA_PATH")
    os.environ["JAMUN_DATA_PATH"] = str(root / "data")
    os.chdir(root)
    try:
        state = train.main(["--experiment-dir", EXP_DIR, "device=cpu", *TRAIN])
        assert state.step == 4
    finally:
        os.chdir(cwd)
        if env is None:
            os.environ.pop("JAMUN_DATA_PATH")
        else:
            os.environ["JAMUN_DATA_PATH"] = env
    return root, str(root / "data")


def _arch(target="jamun_tpu.models.E3Conv"):
    return {"arch": {"_target_": target, "n_layers": 2}}


# (sample config, arch target): every row of JAX's rule, on the card (TPU)
# and the CPU
KERNEL_CASES = [
    ({}, "jamun_tpu.models.E3Conv"),
    ({}, "jamun_tpu_torch.models.E3Conv"),
    ({"finetune_on_init": {"num_steps": 5}}, "jamun_tpu.models.E3Conv"),
    ({"finetune_on_init": {"num_steps": 0}}, "jamun_tpu.models.E3Conv"),
    ({"finetune_on_init": {"num_steps": 5}, "fused_stack": True}, "jamun_tpu.models.E3Conv"),
    ({"fused_stack": False}, "jamun_tpu.models.E3Conv"),
    ({"use_pallas": True}, "jamun_tpu.models.E3Conv"),
    ({"use_pallas": True, "fused_stack": True}, "jamun_tpu.models.E3Conv"),
    ({}, "jamun_tpu.models.Ophiuchus"),
]


@pytest.mark.parametrize("on", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("case", range(len(KERNEL_CASES)))
def test_kernel_defaults_match_jax(case, on):
    cfg, target = KERNEL_CASES[case]
    want, got = _arch(target), _arch(target)
    j_apply(copy.deepcopy(cfg), want, on_tpu=on)
    sample.apply_arch_kernel_defaults(copy.deepcopy(cfg), got, on_card=on)
    assert got == want


def test_use_pallas_false_on_the_card_raises():
    """JAX's explicit use_pallas=false takes its XLA path on the TPU; on the
    card the plain path is refused (the port's device rule). On the CPU it
    is JAX's rule."""
    with pytest.raises(ValueError, match="the card runs the kernels"):
        sample.apply_arch_kernel_defaults({"use_pallas": False}, _arch(), on_card=True)
    got, want = _arch(), _arch()
    sample.apply_arch_kernel_defaults({"use_pallas": False}, got, on_card=False)
    j_apply({"use_pallas": False}, want, on_tpu=False)
    assert got == want == {"arch": dict(_arch()["arch"], use_pallas=False, fused_stack=False)}


@pytest.mark.parametrize("num, repeat, seed", [(1, 1, 0), (2, 3, 5), (100, 2, 1)])
def test_initial_graphs_match_jax(num, repeat, seed, tmp_path):
    root = write_synthetic_data(tmp_path)
    jb, j_map = j_initial_graphs(j_parse(root, *PATTERNS), num, repeat, seed=seed)
    tb, t_map = sample.get_initial_graphs(t_parse(root, *PATTERNS), num, repeat, seed=seed)
    assert t_map == j_map
    for name in ("pos", "node_mask", "atom_type_index", "residue_code_index", "bond_src", "bond_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), name)


def _sample(port_run, monkeypatch, *extra):
    root, data = port_run
    monkeypatch.chdir(root)
    monkeypatch.setenv("JAMUN_DATA_PATH", data)
    return sample.main(["--experiment-dir", EXP_DIR, "device=cpu", *SAMPLE, *extra])


def test_sample_cli_on_a_port_run(port_run, monkeypatch):
    out = _sample(port_run, monkeypatch, "output_dir=runs/test/sampler")
    root = port_run[0]
    sampler_dir = root / "runs" / "test" / "sampler"
    assert tree(sampler_dir) == sampler_layout({"AG": [0], "SV": [1]}, 2)

    # the checkpoint `best_so_far` finds, its EMA weights in the sampling denoiser
    assert os.path.dirname(out["checkpoint"]) == os.path.join("runs", "test", "checkpoints")
    saved = torch.load(root / out["checkpoint"], weights_only=True)
    assert out["state"].step == saved["step"] and out["finetune_losses"] == []
    for k, v in out["denoiser"].arch.state_dict().items():
        assert torch.equal(v, saved["ema_params"][k]), k
    assert out["denoiser"].arch.plain  # use_pallas defaults off on the CPU

    # the CSV: one row per label, the warm rate (batch 1) and the rate over both batches
    with open(sampler_dir / "sampling_times.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["label"] for r in rows] == list(CODES)
    assert list(rows[0]) == ["label", "time_per_sample_seconds", "samples",
                             "time_per_sample_seconds_incl_compile"]
    per_batch = out["per_batch"]
    assert [b["batch_samples"] for b in per_batch] == [2 * 4, 2 * 4]  # 2 chains x 4 frames
    assert float(rows[0]["time_per_sample_seconds"]) == pytest.approx(per_batch[1]["batch_seconds"] / 8)
    assert get_sampling_rate(str(sampler_dir / "sampling_times.csv"), "SV") == float(
        rows[1]["time_per_sample_seconds"])

    # the joined trajectory read back equals the batches' .npy files, in order
    assert list_run_labels(str(root / "runs" / "test")) == list(CODES)
    for label, g in zip(CODES, (0, 1)):
        _, pos = load_run_trajectory(str(root / "runs" / "test"), label)
        parts = [np.load(sampler_dir / label / "predicted_samples" / f"batch_{k}_graph_{g}.npy")
                 for k in range(2)]
        np.testing.assert_allclose(pos, np.concatenate(parts), atol=1e-6)  # DCD stores f32
        assert pos.shape == (8, 8, 3) and np.isfinite(pos).all()
        res = out["results"][label]
        assert res["num_frames"] == 8 and np.isfinite(res["ramachandran_jsd"])
        assert 0.0 <= res["volume_exclusion_rate"] <= 1.0
        assert 0.0 <= res["bond_length_validity_rate"] <= 1.0
        assert np.isfinite(res["score_norm_mean"])


def test_finetune_on_init_moves_the_ema(port_run, monkeypatch):
    out = _sample(port_run, monkeypatch, "output_dir=runs/test/finetuned",
                  "+finetune_on_init.num_steps=3", "+finetune_on_init.log_every=1",
                  "+finetune_on_init.ema_decay=0.5")
    saved = torch.load(port_run[0] / out["checkpoint"], weights_only=True)
    losses = out["finetune_losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out["state"].step == saved["step"] + 3
    moved = [k for k, v in out["denoiser"].arch.state_dict().items()
             if not torch.equal(v, saved["ema_params"][k])]
    assert len(moved) > len(saved["ema_params"]) // 2, moved
    assert tree(port_run[0] / "runs" / "test" / "finetuned") == sampler_layout({"AG": [0], "SV": [1]}, 2)


def test_sample_cli_needs_the_card_or_device_cpu(port_run, monkeypatch):
    """Without `device=cpu` the CLI runs on the card, which this machine
    lacks: it raises before any work."""
    root, data = port_run
    monkeypatch.chdir(root)
    monkeypatch.setenv("JAMUN_DATA_PATH", data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(["--experiment-dir", EXP_DIR, *SAMPLE])
    # several ranks need a process group (torchrun), which this process has not
    with pytest.raises(ValueError, match="process group"):
        sample.main(["--experiment-dir", EXP_DIR, "device=cpu", *SAMPLE, "parallel.num_devices=2"])


def test_sample_cli_atom_sharded_in_one_process(port_run, monkeypatch):
    """`parallel.atom_sharded=true` in one process walks each molecule
    whole on the atom-sharded (plain) path, as JAX's CLI does over a
    one-device mesh: the same files, and samples within 1e-4 of the largest
    entry of the plain run's."""
    _sample(port_run, monkeypatch, "output_dir=runs/test/sampler_plain")
    _sample(port_run, monkeypatch, "output_dir=runs/test/sampler_atom", "parallel.atom_sharded=true")
    root = port_run[0] / "runs" / "test"
    layout = sampler_layout({"AG": [0], "SV": [1]}, 2)
    assert tree(root / "sampler_atom") == tree(root / "sampler_plain") == layout
    for label, g in zip(CODES, (0, 1)):
        for k in range(2):
            name = os.path.join(label, "predicted_samples", f"batch_{k}_graph_{g}.npy")
            got, want = (np.load(root / d / name) for d in ("sampler_atom", "sampler_plain"))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=name)
