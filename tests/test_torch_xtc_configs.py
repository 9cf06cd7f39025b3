"""The repo's `.xtc` configs in the port (CPU): `train_idrome`,
`sample_idrome`, `train_mdgen`, `sample_mdgen`, `sample_capped_2AA` and
`train_idrome_cg` compose as in JAX and read their datasets from synthetic
trees of their layouts (JAX's datasets on the same files where JAX's
discovery finds them); `train_mdgen` then `sample_mdgen`, `sample_capped_2AA`
on `build_peptide(capped=True)` chains and `train_idrome_cg` (the atom-only
embedding) run through the CLIs at a narrow width on the CPU.
"""

import math
import os

import numpy as np
import pytest

from jamun_tpu.config.compose import compose as j_compose
from jamun_tpu.config.instantiate import instantiate as j_instantiate
from jamun_tpu_torch.analysis.load_trajectory import list_run_labels, load_run_trajectory
from jamun_tpu_torch.cmdline import sample, train
from jamun_tpu_torch.cmdline.train import DEFAULT_CONFIG_DIR
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.config.instantiate import instantiate, port_path
from jamun_tpu_torch.data.peptide_builder import build_peptide
from jamun_tpu_torch.data.topology import save_pdb
from jamun_tpu_torch.data.xtc import write_xtc
from jamun_tpu_torch.utils.testing import write_cg_tree, write_idrome_tree
from test_torch_xtc import jax_trajio

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
EXP_DIR = os.path.join(REPO, "configs", "experiment")
JAX_DEFAULTS = os.path.join(REPO, "jamun_tpu", "config", "defaults")
XTC_CONFIGS = ["train_idrome", "sample_idrome", "train_mdgen", "sample_mdgen", "sample_capped_2AA",
               "train_idrome_cg"]
NARROW = ["model.arch.irreps_hidden=16x0e + 8x1e", "model.arch.n_layers=2"]
FRAMES = 24


def _write_flat_xtc(root, seqs, capped=False, seed=0):
    """`<root>/<code>.xtc` and `<code>.pdb`: the built peptide and FRAMES
    frames of it plus N(0, 0.02 nm)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for seq in seqs:
        top, pos = build_peptide(seq, capped=capped)
        save_pdb(os.path.join(root, f"{seq}.pdb"), top, pos)
        write_xtc(os.path.join(root, f"{seq}.xtc"),
                  (pos[None] + rng.normal(0.0, 0.02, (FRAMES,) + pos.shape)).astype(np.float32))


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    """Every layout the six configs read, under one JAMUN_DATA_PATH."""
    root = str(tmp_path_factory.mktemp("data"))
    write_idrome_tree(os.path.join(root, "IDRome_v4_preprocessed", "all_atom_relaxed_combined"),
                      {"idr_a": "GSPEKQNDGS", "idr_b": "SPQNDRGEKA"}, frames=FRAMES, seed=1)
    for split, seqs in (("train", ["KWFE", "RYLD"]), ("val", ["FNEY"]), ("test", ["LKWS", "AGSA"])):
        _write_flat_xtc(os.path.join(root, "mdgen", split), seqs, seed=len(split))
    _write_flat_xtc(os.path.join(root, "capped_diamines", "timewarp_splits", "test"), ["AG", "KW"],
                    capped=True, seed=5)
    for split, seqs in (("train", {"cg_a": "GSPEKQNDGSPE", "cg_b": "SPQNDRGEKAGS"}),
                        ("val", {"cg_c": "GGSPEKQNDA"})):
        write_cg_tree(os.path.join(root, "idrome_cg", split), seqs, frames=FRAMES, seed=7)
    return root


def _mapped(node):
    if isinstance(node, dict):
        return {k: (port_path(v) or v) if k == "_target_" else _mapped(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_mapped(v) for v in node]
    return node


@pytest.mark.parametrize("exp", XTC_CONFIGS)
def test_xtc_config_composes_and_reads_its_layout(exp, data_path, monkeypatch):
    """The composed tree is JAX's; the datasets it names are found in its
    layout, and equal JAX's (labels, frames) where JAX's discovery finds
    them: it lists the root alone, so IDRome's per-protein directories
    stay hidden from it."""
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    jax_trajio()  # JAX's datasets read the .xtc files through it
    name = "train" if exp.startswith("train") else "sample"
    port = compose(os.path.normpath(DEFAULT_CONFIG_DIR), name, [f"experiment={exp}"], EXP_DIR)
    jax_cfg = j_compose(JAX_DEFAULTS, name, [f"experiment={exp}"], EXP_DIR)
    assert _mapped(port) == _mapped(jax_cfg)
    for key in (("data", "datasets"), ("data", "val_datasets")) if name == "train" else (("init_datasets",),):
        cfg, jcfg = port, jax_cfg
        for k in key:
            cfg, jcfg = cfg[k], jcfg[k]
        sets = instantiate(cfg)
        assert sets and all(len(next(iter(d))[1]) == d.template.num_atoms for d in sets)
        if "IDRome" in cfg["root"]:
            assert [d.label() for d in sets] == ["idr_a", "idr_b"]
            with pytest.raises(ValueError, match="No \\(trajectory, pdb\\) pairs"):
                j_instantiate(jcfg)
            continue
        jsets = j_instantiate(jcfg)
        assert [d.label() for d in sets] == [d.label() for d in jsets]
        for d, j in zip(sets, jsets):
            np.testing.assert_array_equal(np.stack([f for _, f in list(d)[:5]]),
                                          np.stack([f for _, f in list(j)[:5]]))


def _train(argv):
    state = train.main(["--experiment-dir", EXP_DIR, "device=cpu", *NARROW, "trainer.max_steps=3",
                        "trainer.val_every_n_steps=3", "trainer.log_every_n_steps=1",
                        "trainer.val_max_batches=1", "data.datamodule.batch_size=4", *argv])
    assert state.step == 3
    return state


def _sample(exp, out, argv=()):
    res = sample.main(["--experiment-dir", EXP_DIR, exp, "device=cpu", "num_sampling_steps_per_batch=6",
                       "num_batches=2", "save_every_n_steps=2", f"output_dir={out}/sampler", *argv])
    labels = list_run_labels(out)
    assert labels == sorted(res["results"])
    for label in labels:
        _, traj = load_run_trajectory(out, label)
        assert traj.shape[0] == 2 * 3 and np.isfinite(traj).all()
        r = res["results"][label]
        assert math.isfinite(r["ramachandran_jsd"])
    assert os.path.exists(os.path.join(out, "sampler", "sampling_times.csv"))
    return labels


def test_train_mdgen_then_sample_mdgen_and_capped(data_path, tmp_path, monkeypatch):
    """`train_mdgen` (streaming `.xtc`, the normalization pre-pass over the
    streams) for 3 steps, then `sample_mdgen` on its checkpoint, and
    `sample_capped_2AA` on capped diamines from the same checkpoint."""
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    monkeypatch.chdir(tmp_path)
    state = _train(["experiment=train_mdgen"])
    assert state.module.tensor_product == "uvw"
    assert _sample("experiment=sample_mdgen", "runs/sample_mdgen") == ["AGSA", "LKWS"]
    ckpt = ["checkpoint_dir=runs/train_mdgen/checkpoints"]
    assert _sample("experiment=sample_capped_2AA", "runs/sample_capped", ckpt) == ["AG", "KW"]


def test_train_idrome_cg_on_beads(data_path, tmp_path, monkeypatch):
    """`train_idrome_cg` builds the atom-only embedding and trains on the
    CA-bead `.dcd` chains, with its default arch and the separable one (a
    group override drops the experiment's arch keys, in JAX's composition
    too, so the flag is given again)."""
    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    monkeypatch.chdir(tmp_path)
    for extra in ([], ["model/arch=e3conv_separable", "model.arch.dtype=null",
                       "model.arch.use_residue_information=false"]):
        state = _train(["experiment=train_idrome_cg", *extra])
        assert hasattr(state.module, "SimpleAtomEmbedding_0")
        assert not hasattr(state.module, "AtomEmbeddingWithResidueInformation_0")


def test_train_idrome_sample_and_analyse(data_path, tmp_path, monkeypatch):
    """`train_idrome` on the IDRome tree (hydrogens in `top.pdb`), then
    `sample_idrome` (its Verlet skin) on the checkpoint, then
    `analysis_sweep` of the samples against the `.xtc` references: every
    label analysed, the TICA and MSM stages included."""
    import json

    from jamun_tpu_torch.analysis import analysis_sweep

    monkeypatch.setenv("JAMUN_DATA_PATH", data_path)
    monkeypatch.chdir(tmp_path)
    _train(["experiment=train_idrome"])
    labels = _sample("experiment=sample_idrome", "runs/sample_idrome")
    assert labels == ["idr_a", "idr_b"]
    ref = os.path.join(data_path, "IDRome_v4_preprocessed", "all_atom_relaxed_combined")
    analysis_sweep.main(["--run-dir", "runs/sample_idrome", "--reference-dir", ref,
                         "--ref-traj-suffix", "/traj.xtc", "--ref-pdb-suffix", "/top.pdb",
                         "--out", "analysis"])
    summary = json.load(open(os.path.join("analysis", "summary.json")))
    assert sorted(summary) == labels
    for label in labels:
        assert "error" not in summary[label], summary[label]
        assert {"tica0_jsd", "msm_state_jsd"} <= set(summary[label])
        assert summary[label]["num_ref_frames"] == FRAMES
