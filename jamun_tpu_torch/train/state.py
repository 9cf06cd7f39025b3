"""Train state and the train / eval steps (counterpart of
`jamun_tpu/train/state.py`).

One step: sigma drawn once per batch on the host, noise from the state's
generator on the model's device, `Denoiser.training_loss`, backward (K4 on
the card), the optimizer (`train/optim.py`: optax's update rules), then the
EMA. Unlike the JAX step, the port's step updates the state in place and
returns it.

Over a mesh (`parallel/mesh.py`) the steps run on every rank. Data
parallel (each rank its slice of the global batch): the loss is the mean
over the valid graphs of every rank (`global_graph_mean`: the masked sums
and the count all-reduced, so padded dummy graphs count nowhere), the
gradients are summed over the ranks, and the noise is this rank's rows of
the global draw (a `GraphShardGenerator`), so a step equals the
single-process step on the global batch. Atom sharded (the denoiser's arch
an `AtomShardedArch`): the batch and loss are replicated and the partial
gradients are summed. Either way `aux` and `grad_norm` are global and the
optimizer and EMA stay equal on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from jamun_tpu_torch.models.denoiser import Denoiser, masked_graph_mean
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.parallel.atom_sharded import AtomShardedArch
from jamun_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, global_graph_mean, make_generator
from jamun_tpu_torch.train.ema import ema_init, ema_update
from jamun_tpu_torch.train.optim import bind
from jamun_tpu_torch.utils.device import resolve_device
from jamun_tpu_torch.utils.trace import span

__all__ = [
    "TrainState", "create_train_state", "make_train_step", "make_eval_step", "global_norm",
    "data_parallel", "denoiser_on",
]


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
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """The state around `denoiser.arch` (moved to `device`, which follows
    `utils.device.resolve_device`: the card unless "cpu"). `optimizer` is a
    factory of `train/optim.py` (e.g. `adam(2e-3)`), bound here to the
    module's parameters (`optim.bind`: with their names). Over a
    data-parallel `mesh` the noise generator draws this rank's rows of the
    global batch's noise."""
    device = resolve_device(device)
    module = denoiser.arch.to(device)
    return TrainState(
        module=module,
        optimizer=bind(optimizer, module),
        ema=ema_init(module),
        step=0,
        generator=make_generator(device, seed, mesh),
        host_generator=torch.Generator().manual_seed(seed),
    )


def data_parallel(denoiser: Denoiser, mesh: Optional[Mesh]) -> bool:
    """Whether a step over `mesh` splits the graphs (not the atoms)."""
    return mesh is not None and mesh.distributed and not isinstance(denoiser.arch, AtomShardedArch)


def denoiser_on(denoiser: Denoiser, module: nn.Module) -> Denoiser:
    """`denoiser`'s configuration around `module` (the EMA weights),
    atom-sharded where `denoiser` is."""
    arch = denoiser.arch
    if isinstance(arch, AtomShardedArch):
        module = AtomShardedArch(module, arch.mesh)
    return Denoiser(module, denoiser.config)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (`optax.global_norm`)."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


def make_train_step(
    denoiser: Denoiser, sigma_distribution, ema_decay: float = 0.999, mesh: Optional[Mesh] = None
) -> Callable[[TrainState, GraphBatch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """One optimisation step on `state.module` (which `denoiser` wraps, or
    its `AtomShardedArch`). Returns (state, aux): aux holds the loss
    metrics, "sigma" and "grad_norm" (of the raw gradients, before the
    update). `mesh`: the ranks the step runs on (module docstring)."""
    loss_mesh = mesh if data_parallel(denoiser, mesh) else None

    def train_step(state: TrainState, batch: GraphBatch):
        sigma = float(sigma_distribution.sample(state.host_generator))
        params = list(state.module.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        with span("jamun.train.forward"):
            loss, aux = denoiser.training_loss(batch, sigma, state.generator, loss_mesh)
        with span("jamun.train.backward"):
            loss.backward()
        if mesh is not None and mesh.distributed:
            with span("jamun.train.all_reduce"):
                all_reduce_grads(params, mesh)
        with span("jamun.train.grad_norm"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            gnorm = global_norm(grads)
        with span("jamun.train.optimizer"):
            state.optimizer.step()
        with span("jamun.train.ema"):
            ema_update(list(state.ema.parameters()), params, ema_decay)
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        aux["sigma"] = torch.tensor(sigma)
        aux["grad_norm"] = gnorm
        return state, aux

    return train_step


def make_eval_step(denoiser: Denoiser, sigma_distribution, mesh: Optional[Mesh] = None):
    """Validation step under `torch.no_grad` on the EMA weights:
    eval_step(state, batch, generator, host_generator) -> aux averaged over
    valid graphs (noise aligned as in training, as the JAX step does); over
    a data-parallel `mesh`, the valid graphs of every rank."""
    loss_mesh = mesh if data_parallel(denoiser, mesh) else None

    def eval_step(state: TrainState, batch: GraphBatch, generator, host_generator):
        sigma = float(sigma_distribution.sample(host_generator))
        den = denoiser_on(denoiser, state.ema)
        with torch.no_grad():
            per_graph, aux = den.noise_and_compute_loss(
                batch, sigma, generator, denoiser.config.align_noisy_input_during_training
            )
            if loss_mesh is None:
                _, aux = masked_graph_mean(per_graph, aux, batch.graph_mask)
            else:
                _, aux = global_graph_mean(per_graph, aux, batch.graph_mask, loss_mesh)
        aux["sigma"] = torch.tensor(sigma)
        return aux

    return eval_step
