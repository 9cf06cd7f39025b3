"""Train state and the train / eval steps (counterpart of
`jamun_tpu/train/state.py`).

One step: sigma drawn once per batch on the host, noise from the state's
generator on the model's device, `Denoiser.training_loss`, backward (K4 on
the card), the optimizer (`train/optim.py`: optax's update rules), then the
EMA. Unlike the JAX step, the port's step updates the state in place and
returns it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Tuple

import torch
from torch import nn

from jamun_tpu_torch.models.denoiser import Denoiser, masked_graph_mean
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.train.ema import ema_init, ema_update
from jamun_tpu_torch.utils.device import resolve_device

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step", "global_norm"]


@dataclasses.dataclass
class TrainState:
    module: nn.Module  # the denoiser's network, trained in place
    optimizer: torch.optim.Optimizer
    ema: nn.Module  # frozen EMA copy of `module`
    step: int
    generator: torch.Generator  # training noise, on the module's device
    host_generator: torch.Generator  # sigma draws: sigma stays a host float


def create_train_state(
    denoiser: Denoiser,
    optimizer: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer],
    seed: int = 0,
    device=None,
) -> TrainState:
    """The state around `denoiser.arch` (moved to `device`, which follows
    `utils.device.resolve_device`: the card unless "cpu"). `optimizer` is a
    factory of `train/optim.py` (e.g. `adam(2e-3)`), bound here to the
    module's parameters."""
    device = resolve_device(device)
    module = denoiser.arch.to(device)
    return TrainState(
        module=module,
        optimizer=optimizer(list(module.parameters())),
        ema=ema_init(module),
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed),
        host_generator=torch.Generator().manual_seed(seed),
    )


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (`optax.global_norm`)."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


def make_train_step(
    denoiser: Denoiser, sigma_distribution, ema_decay: float = 0.999
) -> Callable[[TrainState, GraphBatch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """One optimisation step on `state.module` (which `denoiser` wraps).
    Returns (state, aux): aux holds the loss metrics, "sigma" and
    "grad_norm" (of the raw gradients, before the update)."""

    def train_step(state: TrainState, batch: GraphBatch):
        sigma = float(sigma_distribution.sample(state.host_generator))
        params = list(state.module.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = denoiser.training_loss(batch, sigma, state.generator)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        gnorm = global_norm(grads)
        state.optimizer.step()
        ema_update(list(state.ema.parameters()), params, ema_decay)
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        aux["sigma"] = torch.tensor(sigma)
        aux["grad_norm"] = gnorm
        return state, aux

    return train_step


def make_eval_step(denoiser: Denoiser, sigma_distribution):
    """Validation step under `torch.no_grad` on the EMA weights:
    eval_step(state, batch, generator, host_generator) -> aux averaged over
    valid graphs (noise aligned as in training, as the JAX step does)."""

    def eval_step(state: TrainState, batch: GraphBatch, generator, host_generator):
        sigma = float(sigma_distribution.sample(host_generator))
        den = Denoiser(state.ema, denoiser.config)
        with torch.no_grad():
            per_graph, aux = den.noise_and_compute_loss(
                batch, sigma, generator, denoiser.config.align_noisy_input_during_training
            )
            _, aux = masked_graph_mean(per_graph, aux, batch.graph_mask)
        aux["sigma"] = torch.tensor(sigma)
        return aux

    return eval_step
