"""The reference against the port's plain CPU path at a small size, and the
reference's imports."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.inputs.batches import train_pool, walk_batch
from benchmark.reference import denoiser as rd
from benchmark.reference import train as rt
from benchmark.reference.model import E3Conv as RefNet
from benchmark.tests.conftest import ROOT
from benchmark.weights import make_weights

ARCH = dict(
    irreps_out="1x1e", irreps_hidden="8x0e + 4x1e", irreps_sh="1x0e + 1x1e", n_layers=2, edge_attr_dim=64,
    atom_type_embedding_dim=8, atom_code_embedding_dim=8, residue_code_embedding_dim=32,
    residue_index_embedding_dim=8, use_residue_information=True, use_residue_sequence_index=False,
)
DEN = dict(max_radius=1.0, average_squared_distance=0.5)
MIX = dict(residues=[4], max_atoms=48, basins=["alpha", "beta", "ppii"], jitter_deg=15.0, sequences=2,
           chains_per_sequence=2, bucket=48, batch_size=3, pool_batches=3, structure_seed=7)


def _models(tp: str, seed: int = 5):
    from jamun_tpu_torch.models.e3conv import E3Conv

    arch = dict(ARCH, tensor_product=tp)
    ref = RefNet(arch)
    w = make_weights([(n, tuple(p.shape)) for n, p in ref.named_parameters()], seed, "cpu")
    ref.load_state_dict(w)
    port = E3Conv(**arch, plain=True, device="cpu")
    port.load_state_dict(w)
    return ref, port, w


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import benchmark.reference.model, benchmark.reference.denoiser, benchmark.reference.walk,"
        " benchmark.reference.train, benchmark.reference.precision, benchmark.reference.cg;"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert "benchmark" in loaded
    assert not loaded & {"jamun_tpu_torch", "jamun_tpu", "jax", "jaxlib", "flax", "optax"}, loaded


@pytest.mark.parametrize("tp", ["uvu", "uvw"])
def test_score_matches_the_port(tp):
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.ops.graph import GraphBatch

    ref, port, _ = _models(tp)
    b = {k: torch.as_tensor(v) for k, v in walk_batch(3, MIX).items()}
    gen = torch.Generator().manual_seed(0)
    y = b["pos"] + 0.04 * torch.randn(b["pos"].shape, generator=gen) * b["node_mask"][..., None]
    with torch.no_grad():
        want = Denoiser(port, DenoiserConfig(**DEN)).score(GraphBatch(**b).replace_pos(y), 0.04)
        got = rd.score(ref, b, y, 0.04, DEN)
    m = b["node_mask"][..., None]
    assert float(((got - want) * m).abs().max()) <= 1e-5 * float((want * m).abs().max())


def test_training_steps_match_the_port():
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.ops.graph import GraphBatch
    from jamun_tpu_torch.train.distributions import ConstantSigma
    from jamun_tpu_torch.train.optim import adam
    from jamun_tpu_torch.train.state import create_train_state, make_train_step

    ref, port, w = _models("uvw")
    pool = train_pool(4, MIX)
    den = Denoiser(port, DenoiserConfig(**DEN))
    state = create_train_state(den, adam(2e-3), seed=11, device="cpu")
    step = make_train_step(den, ConstantSigma(0.04), 0.999)
    losses, grad1 = [], None
    for k, b in enumerate(pool):
        state, aux = step(state, GraphBatch(**{n: torch.as_tensor(v) for n, v in b.items()}))
        losses.append(float(aux["loss"]))
        if k == 0:
            grad1 = {n: state.optimizer.state[p]["mu"] / 0.1 for n, p in state.module.named_parameters()}
    program = {
        "losses": losses, "grad1": grad1,
        "change": {n: p.detach() - w[n] for n, p in state.module.named_parameters()},
        "ema_change": {n: p.detach() - w[n] for n, p in state.ema.named_parameters()},
    }
    batches = [{n: torch.as_tensor(v) for n, v in b.items()} for b in pool]
    noise = rt.noise_draws(11, pool[0]["pos"].shape, len(pool), "cpu")
    want = rt.reference_steps(ref, batches, noise, 0.04, DEN, dict(b1=0.9, b2=0.999, eps=1e-8, learning_rate=2e-3),
                              0.999)
    numbers = rt.train_numbers(program, want)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4 and numbers["change_gap"] < 1e-3, numbers
    assert np.isfinite(list(numbers.values())).all()
