"""The port's sample CLI on a run directory that JAX's train CLI wrote (CPU):
JAX trains `experiment=train_test` for 4 steps (its flax-msgpack
checkpoints and pickled config), JAX's sample CLI samples it with
`experiment=sample_test` (20 steps, 2 batches), and the port's CLI samples
the same run with `device=cpu`. The port restores JAX's checkpoint (EMA
parameters bit for bit into its sampling denoiser, the step) and writes the
file layout JAX's CLI wrote, with the same CSV columns and frame counts.
The walks draw from different generators, so the samples differ."""

import csv
import os

import numpy as np
import pytest
import torch

from jamun_tpu.cmdline import sample as jsample
from jamun_tpu.cmdline import train as jtrain
from jamun_tpu_torch.cmdline import sample
from jamun_tpu_torch.params import from_jax_params
from jamun_tpu_torch.train.checkpoints import read_flax_msgpack
from test_torch_sample_cli import EXP_DIR, SAMPLE, TRAIN, sampler_layout, tree, write_synthetic_data


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's train CLI, then JAX's sample CLI, in one work directory."""
    root = tmp_path_factory.mktemp("jax_run")
    write_synthetic_data(root / "data")
    mp = pytest.MonkeyPatch()
    mp.setenv("JAMUN_DATA_PATH", str(root / "data"))
    mp.chdir(root)
    try:
        jtrain.main(["--experiment-dir", EXP_DIR, *TRAIN])
        jsample.main(["--experiment-dir", EXP_DIR, *SAMPLE, "output_dir=runs/test/jax_sampler"])
    finally:
        mp.undo()
    return root


@pytest.fixture(scope="module")
def port_out(jax_run):
    """The port's sample CLI on JAX's run: (its result, JAX's sampler
    directory, the port's)."""
    mp = pytest.MonkeyPatch()
    mp.chdir(jax_run)
    mp.setenv("JAMUN_DATA_PATH", str(jax_run / "data"))
    try:
        out = sample.main(["--experiment-dir", EXP_DIR, "device=cpu", *SAMPLE,
                           "output_dir=runs/test/port_sampler"])
    finally:
        mp.undo()
    runs = jax_run / "runs" / "test"
    return out, runs / "jax_sampler", runs / "port_sampler"


def test_port_writes_jax_layout(port_out):
    _, jax_dir, port_dir = port_out
    assert tree(port_dir) == tree(jax_dir) == sampler_layout({"AG": [0], "SV": [1]}, 2)
    for name in tree(jax_dir):
        if name.endswith(".npy"):
            got, want = np.load(port_dir / name), np.load(jax_dir / name)
            assert got.shape == want.shape and np.isfinite(got).all(), name


def test_port_restores_jax_checkpoint(port_out, jax_run):
    """The checkpoint `best_so_far` finds is JAX's flax file: the EMA
    parameters bit for bit in the sampling denoiser, the parameters in the
    state, the step."""
    out, _, _ = port_out
    path = jax_run / out["checkpoint"]
    with open(path, "rb") as f:
        assert 0x80 <= f.read(1)[0] <= 0x8F  # a msgpack map: flax's format
    saved = read_flax_msgpack(str(path))
    assert out["state"].step == int(saved["step"])
    for tree_name, module in (("ema_params", out["denoiser"].arch), ("params", out["state"].module)):
        want, got = from_jax_params(saved[tree_name]), module.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (tree_name, k)


def test_port_csv_matches_jax_columns(port_out):
    _, jax_dir, port_dir = port_out

    def rows(d):
        with open(d / "sampling_times.csv") as f:
            return list(csv.DictReader(f))

    j_rows, t_rows = rows(jax_dir), rows(port_dir)
    assert [list(r) for r in t_rows] == [list(r) for r in j_rows]
    assert [(r["label"], r["samples"]) for r in t_rows] == [(r["label"], r["samples"]) for r in j_rows]
    assert all(float(r["time_per_sample_seconds"]) > 0 for r in t_rows)
