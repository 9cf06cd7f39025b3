"""The port's config layer against JAX's (CPU): composition of every
experiment, the copy of the defaults tree, what each training experiment's
arch builds, the constructor and dataclass defaults, and the ROADMAP titles
that the port's `NotImplementedError`s name.

Targets are compared through the port's fixed table (`port_path`):
`jamun_tpu.<path>` -> `jamun_tpu_torch.<path>`, `optax.{adam,adamw,adagrad}`
-> `jamun_tpu_torch.train.optim.*`. Both sides read YAML with PyYAML's
`safe_load` (the port carries no reader of its own: PyYAML is installed
where the port runs).
"""

import ast
import dataclasses
import importlib
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from jamun_tpu.config.compose import compose as j_compose
from jamun_tpu.config.instantiate import instantiate as j_instantiate
from jamun_tpu.data.batching import collate as j_collate
from jamun_tpu.data.topology import Atom, Topology, preprocess_topology
from jamun_tpu.models.denoiser import DenoiserConfig as JDenoiserConfig
from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu.train.loop import TrainerConfig as JTrainerConfig
from jamun_tpu_torch.cmdline.train import DEFAULT_CONFIG_DIR
from jamun_tpu_torch.config.instantiate import _OTHER, _UNPORTED, instantiate, port_path
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.models.denoiser import DenoiserConfig
from jamun_tpu_torch.models import (
    CoarseGrainedBeadEmbedding,
    Ophiuchus,
    SimpleAtomEmbedding,
)
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.sampling import UnrolledBAOAB, VESDEReverseDiffusionSampler
from jamun_tpu_torch.train.loop import TrainerConfig

REPO = os.path.join(os.path.dirname(__file__), "..")
EXP_DIR = os.path.join(REPO, "configs", "experiment")
JAX_DEFAULTS = os.path.join(REPO, "jamun_tpu", "config", "defaults")
PORT_DEFAULTS = os.path.normpath(DEFAULT_CONFIG_DIR)
EXPERIMENTS = sorted(f[: -len(".yaml")] for f in os.listdir(EXP_DIR) if f.endswith(".yaml"))
ROADMAP = open(os.path.join(REPO, "ROADMAP.md")).read()
TITLE_RE = re.compile(r"""ROADMAP\.md\s+queue\s+A,[\s"]*'([^']+)'""")


def _mapped(node):
    """The tree with every `_target_` through the port's table."""
    if isinstance(node, dict):
        return {k: (port_path(v) or v) if k == "_target_" else _mapped(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_mapped(v) for v in node]
    return node


def _compose_both(exp: str, overrides=()):
    name = "train" if exp.startswith("train") else "sample"
    ovs = [f"experiment={exp}", *overrides]
    return compose(PORT_DEFAULTS, name, ovs, EXP_DIR), j_compose(JAX_DEFAULTS, name, ovs, EXP_DIR)


def test_seventeen_experiments():
    assert len(EXPERIMENTS) == 17, EXPERIMENTS


@pytest.mark.parametrize("exp", EXPERIMENTS)
def test_compose_equals_jax(exp, monkeypatch):
    """Defaults lists, `@package _global_`, interpolation (env included) and
    dotted overrides give JAX's tree once targets are mapped; so do a group
    override and a `device` override on the training side."""
    monkeypatch.setenv("JAMUN_DATA_PATH", "/data/somewhere")
    port, jax_cfg = _compose_both(exp)
    assert _mapped(port) == _mapped(jax_cfg)
    if exp.startswith("train"):
        port, jax_cfg = _compose_both(exp, ["model/arch=e3conv_separable", "trainer.max_steps=7",
                                            "device=cpu"])
        assert _mapped(port) == _mapped(jax_cfg)
        assert port["model"]["arch"]["tensor_product"] == "uvu" and port["device"] == "cpu"


def _yaml_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".yaml"))


def test_defaults_tree_equals_jax():
    """Every file of `jamun_tpu/config/defaults/` has its copy in the port,
    equal under the table (and the port's targets name the port)."""
    files = _yaml_files(JAX_DEFAULTS)
    assert files == _yaml_files(PORT_DEFAULTS) and len(files) == 16
    for rel in files:
        with open(os.path.join(JAX_DEFAULTS, rel)) as f:
            want = _mapped(yaml.safe_load(f))
        with open(os.path.join(PORT_DEFAULTS, rel)) as f:
            text = f.read()
        assert yaml.safe_load(text) == want, rel
        for target in re.findall(r"_target_:\s*(\S+)", text):
            assert target.startswith("jamun_tpu_torch."), (rel, target)
        # the package line, where JAX's file has one
        with open(os.path.join(JAX_DEFAULTS, rel)) as f:
            assert ("@package _global_" in f.read()) == ("@package _global_" in text), rel


def _bold_title(title: str) -> bool:
    return f"**{title}" in ROADMAP


@pytest.mark.parametrize("exp", [e for e in EXPERIMENTS if e.startswith("train")])
def test_train_arch_builds_or_names_its_item(exp):
    """Each training experiment's `model.arch` (the repo's uvw e3conv at its
    full width, or the CG chains' SimpleAtomEmbedding) builds in the port on
    the CPU, or raises NotImplementedError naming a bold ROADMAP.md title."""
    port, _ = _compose_both(exp)
    try:
        arch = instantiate(port["model"]["arch"], device="cpu", seed=0)
    except NotImplementedError as e:
        titles = TITLE_RE.findall(str(e))
        assert titles and all(_bold_title(t) for t in titles), str(e)
        return
    assert isinstance(arch, E3Conv)
    assert arch.tensor_product == port["model"]["arch"]["tensor_product"]
    assert arch.irreps_hidden == arch.irreps_hidden.__class__(port["model"]["arch"]["irreps_hidden"])


def test_other_archs_build_or_name_their_item():
    """The separable flagship builds with bf16 and the kernels on; Ophiuchus
    builds at the config's full width with as many parameters as JAX's
    `init` gives it (on three alanines: the count does not depend on the
    residues)."""
    port, _ = _compose_both("train_uncapped_4AA", ["model/arch=e3conv_separable"])
    arch = instantiate(port["model"]["arch"], device="cpu", seed=0)
    assert arch.kernels and arch.tensor_product == "uvu" and str(arch.dtype) == "torch.bfloat16"
    port, jax_cfg = _compose_both("train_uncapped_4AA", ["model/arch=ophiuchus"])
    arch = instantiate(port["model"]["arch"], device="cpu", seed=0)
    assert isinstance(arch, Ophiuchus) and arch.tensor_product == "uvw"
    jarch = j_instantiate(jax_cfg["model"]["arch"])
    atoms = [Atom(index=i, name=n, element=n[0], residue_name="ALA", residue_index=i // 4,
                  residue_seq=i // 4 + 1) for i, n in enumerate(["N", "CA", "C", "O"] * 3)]
    pos = np.arange(36, dtype=np.float32).reshape(12, 3) * 0.05
    batch = j_collate([(preprocess_topology(Topology(atoms=atoms, bonds=[]), pos)[0], pos)])
    shapes = jax.eval_shape(jarch.init, jax.random.PRNGKey(0), batch, jnp.zeros((1,)), 1.0)
    assert sum(p.numel() for p in arch.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_former_unported_targets_build():
    """The five targets the resolver's table named until the port had them
    build through `instantiate` as the port's classes; the table names no
    target whose module has it."""
    for target, kw, cls in (
        ("jamun_tpu.models.Ophiuchus", {"device": "cpu"}, Ophiuchus),
        ("jamun_tpu.sampling.VESDEReverseDiffusionSampler", {}, VESDEReverseDiffusionSampler),
        ("jamun_tpu.sampling.UnrolledBAOAB", {"config": {
            "_target_": "jamun_tpu.sampling.MCMCConfig", "steps": 5}}, UnrolledBAOAB),
        ("jamun_tpu.models.SimpleAtomEmbedding", {"embedding_dim": 4}, SimpleAtomEmbedding),
        ("jamun_tpu.models.CoarseGrainedBeadEmbedding", {"bead_embedding_dim": 4},
         CoarseGrainedBeadEmbedding),
    ):
        assert type(instantiate({"_target_": target, **kw})) is cls, target
    for port in _UNPORTED:
        module_path, _, attr = port.rpartition(".")
        assert not hasattr(importlib.import_module(module_path), attr), port


def test_defaults_equal_jax():
    """The constructor and dataclass defaults of E3Conv, DenoiserConfig and
    TrainerConfig are JAX's, so that a config that leaves a key unset trains
    the same model for the same length. Excluded, port-only: `device` (the
    port's device rule), `seed` (the port draws parameters in the
    constructor, JAX in `init`), `plain` (the CPU reference path); and
    `nbr_geom_kernel`, which JAX reads from the environment
    (JAMUN_NBR_GEOM_KERNEL), not from a field. `use_pallas` is compared
    apart: the port's card runs the kernels, so it defaults to True where
    JAX's default False takes XLA; False is `plain=True`, refused on the
    card (checked below)."""
    port_only = {"self", "device", "seed", "plain", "nbr_geom_kernel", "use_pallas"}
    sig = {n: p.default for n, p in inspect.signature(E3Conv.__init__).parameters.items()
           if n not in port_only}
    jax_fields = {f.name: f.default for f in dataclasses.fields(JE3Conv) if f.name not in ("parent", "name")}
    assert set(sig) <= set(jax_fields), set(sig) - set(jax_fields)
    assert {n: jax_fields[n] for n in sig} == sig
    assert sig["tensor_product"] == "uvw"
    assert inspect.signature(E3Conv.__init__).parameters["use_pallas"].default is True
    assert jax_fields["use_pallas"] is False
    for kw in ({"use_pallas": False}, {"plain": True}):
        m = E3Conv(irreps_hidden="8x0e + 4x1e", n_layers=1, tensor_product="uvu", device="cpu", seed=0, **kw)
        assert m.plain and not m.kernels, kw
    assert E3Conv(irreps_hidden="8x0e + 4x1e", n_layers=1, tensor_product="uvu", device="cpu").kernels

    for port_cls, jax_cls in ((DenoiserConfig, JDenoiserConfig), (TrainerConfig, JTrainerConfig)):
        def fields(cls):
            return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]
        assert fields(port_cls) == fields(jax_cls), port_cls.__name__
    assert (TrainerConfig().max_epochs, TrainerConfig().max_steps) == (10, None)


def _port_sources():
    root = os.path.join(REPO, "jamun_tpu_torch")
    for d, _, fs in os.walk(root):
        for f in sorted(fs):
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    yield os.path.relpath(path, REPO), fh.read()


def test_roadmap_titles_named_by_the_port_exist():
    """Every `ROADMAP.md queue A, '<title>'` in the port's sources (and each
    title of the config resolver's table) names a bold title of ROADMAP.md;
    no source cites a queue-A item by number."""
    seen = set()
    for rel, text in _port_sources():
        assert not re.search(r"queue\s+A\s+item", text), rel
        assert len(re.findall(r"ROADMAP\.md\s+queue\s+A\b", text)) == len(TITLE_RE.findall(text)), rel
        for title in TITLE_RE.findall(text):
            if title == "{title}":  # the resolver's helper; its titles are checked below
                continue
            assert _bold_title(title), (rel, title)
            seen.add(title)
    for title in (*_UNPORTED.values(), _OTHER):
        assert _bold_title(title), title
    # exactly the items the port still names: a ported item's raise goes
    # with it, and a new raise needs its item here
    assert seen == {
        "Dense messages beyond one CTA", "Edge features at sizes no configuration reaches",
        "Kernel shapes outside the configurations", "Offloaded walks with burn-in",
        "Other config targets", "Position gradients through the kernels",
        "Sparse messages from 65536 atoms on", "The sample CLI",
    }, sorted(seen)


def test_every_not_implemented_error_names_a_title():
    """Each `raise NotImplementedError(...)` in the port names its queue-A
    item: the title in the message, or a module constant or helper that
    holds one."""
    for rel, text in _port_sources():
        for node in ast.walk(ast.parse(text)):
            if not (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", None) == "NotImplementedError"):
                continue
            seg = ast.get_source_segment(text, node)
            assert ("ROADMAP.md queue A" in seg or "_LIMITS" in seg or "_OTHER" in seg
                    or "_roadmap(" in seg), f"{rel}:{node.lineno}: {seg}"
