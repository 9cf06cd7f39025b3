"""JAX's `E3Conv` fields in the port's `E3Conv` (CPU): every dataclass
field is a constructor parameter with JAX's default, `atom_axis` takes the
default process group by JAX's axis name "data" (and refuses any other
name), and the repo's arch files build with each of
the last three fields spelled, through the port's config composition and
resolver. The JAX module is read for its fields only; nothing of it runs.
"""

import dataclasses
import inspect
import os

import pytest
import torch

from jamun_tpu.models.e3conv import E3Conv as JE3Conv
from jamun_tpu_torch.cmdline.train import DEFAULT_CONFIG_DIR
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.models.e3conv import E3Conv
from jamun_tpu_torch.utils.testing import make_test_batch

REPO = os.path.join(os.path.dirname(__file__), "..")
EXP_DIR = os.path.join(REPO, "configs", "experiment")
SMALL = dict(irreps_hidden="8x0e + 4x1e", n_layers=2, tensor_product="uvu", device="cpu", seed=0)
# what the port's E3Conv does with each of JAX's last three fields
SPELLED = {
    "atom_axis": ("null",),
    "scan_layers": ("true", "false"),
    "tiled_kernel_training": ("true", "false"),
}


def test_every_jax_field_is_a_parameter_with_its_default():
    """All of JAX's dataclass fields but flax's `parent` and `name`; the
    defaults equal, except `use_pallas`, which the port's card defaults to
    True (False is `plain=True`, the CPU reference path; held in
    `tests/test_torch_config.py::test_defaults_equal_jax`)."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JE3Conv)
                  if f.name not in ("parent", "name")}
    params = inspect.signature(E3Conv.__init__).parameters
    missing = set(jax_fields) - set(params)
    assert not missing, missing
    differ = {n: (params[n].default, d) for n, d in jax_fields.items()
              if params[n].default != d and n != "use_pallas"}
    assert not differ, differ
    for name in SPELLED:
        assert name in jax_fields


@pytest.mark.parametrize("value", ["data", "atoms"])
def test_atom_axis_names_parallel(value):
    """"data" is the default process group's name (the atom-sharded mode,
    `parallel/atom_sharded.py`): kept, and a forward without a process group
    raises; any other name raises at construction."""
    if value != "data":
        with pytest.raises(ValueError, match="a process group, or 'data'"):
            E3Conv(**SMALL, atom_axis=value)
        return
    m = E3Conv(**SMALL, atom_axis=value)
    assert m.atom_axis == "data"
    batch = make_test_batch(num_graphs=1, max_nodes=6, device="cpu")
    with pytest.raises(ValueError, match="default process group, which is not set up"):
        m(batch, torch.zeros(1), 1.0)


def test_fields_are_kept():
    m = E3Conv(**SMALL, atom_axis=None, scan_layers=True, tiled_kernel_training=True)
    assert (m.atom_axis, m.scan_layers, m.tiled_kernel_training) == (None, True, True)
    m = E3Conv(**SMALL)
    assert (m.atom_axis, m.scan_layers, m.tiled_kernel_training) == (None, False, False)


@pytest.mark.parametrize("arch", ["e3conv", "e3conv_separable"])
@pytest.mark.parametrize("override", [f"{k}={v}" for k, vs in SPELLED.items() for v in vs])
def test_arch_files_build_with_each_field_spelled(arch, override):
    """`experiment=train_uncapped_4AA model/arch=<arch> model.arch.<field>=<v>`
    composes and its arch builds on the CPU at the file's full width, with
    the field's value on the module."""
    cfg = compose(os.path.normpath(DEFAULT_CONFIG_DIR), "train",
                  ["experiment=train_uncapped_4AA", f"model/arch={arch}", f"model.arch.{override}"],
                  EXP_DIR)
    field, value = override.split("=")
    want = {"null": None, "true": True, "false": False}[value]
    assert cfg["model"]["arch"][field] == want
    model = instantiate(cfg["model"]["arch"], device="cpu", seed=0)
    assert isinstance(model, E3Conv) and getattr(model, field) == want
    assert model.n_layers == cfg["model"]["arch"]["n_layers"] == 5


def test_arch_file_with_atom_axis_set_names_parallel():
    """An arch file's `atom_axis` other than JAX's "data" raises as it builds."""
    cfg = compose(os.path.normpath(DEFAULT_CONFIG_DIR), "train",
                  ["experiment=train_uncapped_4AA", "model.arch.atom_axis=atoms"], EXP_DIR)
    with pytest.raises(ValueError, match="a process group, or 'data'"):
        instantiate(cfg["model"]["arch"], device="cpu", seed=0)
