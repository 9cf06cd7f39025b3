"""The training driver: epochs, validation, checkpoints, throughput
(counterpart of `jamun_tpu/train/loop.py:52-219`).

`Trainer(config, loggers).fit(denoiser, optimizer, sigma_distribution,
datamodule, resume_from)` trains `denoiser.arch` in place for up to
`max_epochs` epochs or `max_steps` steps, logs every `log_every_n_steps`,
validates on the EMA weights every `val_every_n_steps` (or at each epoch's
end) and saves a checkpoint at every validation (`train/checkpoints.py`),
stops on a non-finite validation loss when `check_finite` is set,
collects the sigma diagnostics, and with `visualize_denoise_sigmas` logs
`val/scaled_rmsd_sigma{s}` at each validation (`visualize_denoise_metrics`).

Under a process group (`parallel/distributed.py`: torchrun, one rank per
card) `fit` runs JAX's mesh dispatch (`jamun_tpu/train/loop.py:93-148`):
`make_mesh(num_devices)`, then `resolve_atom_sharded(atom_sharded, N,
atom_shard_threshold, ranks)` on the first training batch. Atom sharded,
every rank holds each batch whole (atoms padded to a multiple of the ranks,
bonds repartitioned) and runs the arch on its rows; otherwise data parallel,
each rank takes its slice of the graphs (the global batch padded with
masked dummy graphs). Validation and the denoise visualization run on the
batches prepared the same way. Only rank 0 writes checkpoints,
`metrics.csv` and the diagnostics. With one process nothing changes. There
is no counterpart of JAX's kernel fallback (`step_with_fallback`): a step
that fails (a kernel that does not build or launch, a shape outside the
kernels) raises out of `fit`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Dict, Optional

import torch

from jamun_tpu_torch.models.denoiser import Denoiser
from jamun_tpu_torch.parallel.atom_sharded import (
    denoiser_with_atom_sharding,
    pad_atoms_to_multiple,
    prepare_atom_sharded_batch,
    resolve_atom_sharded,
)
from jamun_tpu_torch.parallel.distributed import rank
from jamun_tpu_torch.parallel.mesh import (
    make_generator,
    make_mesh,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)
from jamun_tpu_torch.train.checkpoints import CheckpointManager, restore_checkpoint
from jamun_tpu_torch.train.diagnostics import SigmaDistributionDiagnostics, visualize_denoise_metrics
from jamun_tpu_torch.train.loggers import ConsoleLogger, MultiLogger
from jamun_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from jamun_tpu_torch.utils.device import resolve_device
from jamun_tpu_torch.utils.trace import span

log = logging.getLogger("jamun_tpu_torch")

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 10
    max_steps: Optional[int] = None
    val_every_n_steps: Optional[int] = None  # None: validate at each epoch's end
    val_max_batches: int = 50
    log_every_n_steps: int = 50
    checkpoint_dir: str = "checkpoints"
    checkpoint_top_k: int = 5
    ema_decay: float = 0.999
    check_finite: bool = True  # stop on a non-finite validation loss
    num_devices: Optional[int] = None  # ranks of the process group (None: all of them)
    atom_sharded: object = "auto"  # false | true | "auto": shard each molecule's atoms
    # over the ranks instead of the graphs ("auto": from atom_shard_threshold on)
    atom_shard_threshold: int = 1024
    seed: int = 0
    collect_sigma_diagnostics: bool = True  # sigma against loss and grad norm, a CSV per epoch
    visualize_denoise_sigmas: tuple = ()  # per-sigma denoise metrics at each validation


class Trainer:
    """`device` follows `utils.device.resolve_device` (the card unless
    "cpu"; under a process group the rank's card); the module, the state
    and every batch go there (a batch through `GraphBatch.to_device`: from
    page-locked host memory without a wait). Only rank 0 logs, checkpoints
    and collects the diagnostics."""

    def __init__(self, config: TrainerConfig, loggers=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.writer = rank() == 0
        self.logger = loggers or MultiLogger(ConsoleLogger(every_n=1))
        self.ckpt = (
            CheckpointManager(config.checkpoint_dir, top_k=config.checkpoint_top_k)
            if self.writer else None
        )
        self.diagnostics = (
            SigmaDistributionDiagnostics(os.path.join(config.checkpoint_dir, "..", "diagnostics"))
            if config.collect_sigma_diagnostics and self.writer
            else None
        )

    def fit(
        self,
        denoiser: Denoiser,
        optimizer,
        sigma_distribution,
        datamodule,
        resume_from: Optional[str] = None,
    ) -> TrainState:
        """`optimizer` is a factory of `train/optim.py`; `datamodule` gives
        `train_batches(epoch)` and `val_batches()` (`data.DataModule`)."""
        cfg = self.config
        if getattr(datamodule, "streaming", False) and not cfg.max_steps:
            # streaming batches are epoch-less (`DataModule._iter_batches` yields
            # forever), so a max_epochs-only budget would never end epoch 0
            raise ValueError(
                "streaming datamodules are epoch-less: set trainer.max_steps "
                "(max_epochs alone never terminates a streaming epoch)"
            )
        mesh = make_mesh(cfg.num_devices)
        state = create_train_state(denoiser, optimizer, seed=cfg.seed, device=self.device,
                                   mesh=self._dispatch(datamodule, mesh))
        if self._atom_sharded:
            denoiser = denoiser_with_atom_sharding(denoiser, mesh)
        if resume_from:
            restore_checkpoint(resume_from, state)
            log.info("resumed from %s at step %d", resume_from, state.step)
        replicate(state, mesh)
        train_step = make_train_step(denoiser, sigma_distribution, cfg.ema_decay, mesh)
        eval_step = make_eval_step(denoiser, sigma_distribution, mesh)

        samples_seen = 0
        t_start = time.perf_counter()
        stop = False
        for epoch in range(cfg.max_epochs):
            if stop:
                break
            for batch in datamodule.train_batches(epoch):
                with span("jamun.train.step"):
                    with span("jamun.train.to_device"):
                        batch = self._prep(batch)
                    state, aux = train_step(state, batch)
                    step = state.step
                    samples_seen += batch.pos.shape[0] * (self._dp_mesh.size if self._dp_mesh else 1)
                    if step % cfg.log_every_n_steps == 0 and self.writer:
                        with span("jamun.train.log"):
                            self._log(aux, step, epoch, samples_seen, t_start)
                if cfg.val_every_n_steps and step % cfg.val_every_n_steps == 0:
                    stop = self._validate(state, eval_step, datamodule, denoiser) or stop
                if cfg.max_steps and step >= cfg.max_steps:
                    stop = True
                if stop:
                    break
            if not cfg.val_every_n_steps:
                stop = self._validate(state, eval_step, datamodule, denoiser) or stop
            if self.diagnostics:
                self.diagnostics.flush(epoch)
        if self.writer:
            self.logger.finalize()
        return state

    def _log(self, aux, step: int, epoch: int, samples_seen: int, t_start: float) -> None:
        """The log step's metrics: the step's aux read on the host, the
        throughput since `fit` started."""
        with span("jamun.host.wait:log_read"):
            host_aux = {k: float(v) for k, v in aux.items()}
        if self.diagnostics:
            self.diagnostics.update(host_aux, step)
        metrics = {f"train/{k}": v for k, v in host_aux.items()}
        elapsed = time.perf_counter() - t_start
        metrics["train/samples_per_sec"] = samples_seen / elapsed
        metrics["train/steps_per_sec"] = step / elapsed
        metrics["epoch"] = epoch
        self.logger.log_metrics(metrics, step)

    def _dispatch(self, datamodule, mesh):
        """JAX's dispatch on the mesh: whether the steps shard atoms
        (`_atom_sharded`) and how each batch is prepared (`_prep`). Returns
        the data-parallel mesh (`_dp_mesh`), None when the graphs are not
        split."""
        cfg = self.config
        n_atoms = 0
        if mesh.size > 1 and cfg.atom_sharded not in (False, None, "false", "off"):
            batches = iter(datamodule.train_batches(0))
            n_atoms = next(batches).pos.shape[1]
            if hasattr(batches, "close"):
                batches.close()  # stops the prefetch thread
        self._atom_sharded = resolve_atom_sharded(
            cfg.atom_sharded, n_atoms, cfg.atom_shard_threshold, mesh.size
        )
        self._dp_mesh = mesh if mesh.distributed and not self._atom_sharded else None
        if self._atom_sharded:
            log.info("atom-sharded mode: N=%d atoms split over %d devices", n_atoms, mesh.size)
            self._prep = lambda b: prepare_atom_sharded_batch(  # noqa: E731
                pad_atoms_to_multiple(b, mesh.size), mesh
            ).to_device(self.device)
        elif self._dp_mesh is not None:
            self._prep = lambda b: shard_batch(  # noqa: E731
                pad_batch_to_multiple(b, mesh.size), mesh
            ).to_device(self.device)
        else:
            self._prep = lambda b: b.to_device(self.device)  # noqa: E731
        return self._dp_mesh

    def _validate(self, state: TrainState, eval_step, datamodule, denoiser: Denoiser) -> bool:
        """Logs val/* averaged over batches and saves a checkpoint; True when
        training should stop (a non-finite loss)."""
        cfg = self.config
        seed = cfg.seed + state.step
        generator = make_generator(self.device, seed, self._dp_mesh)
        host_generator = torch.Generator().manual_seed(seed)
        totals: Dict[str, float] = {}
        n = 0
        for batch in datamodule.val_batches():
            if n >= cfg.val_max_batches:
                break
            aux = eval_step(state, self._prep(batch), generator, host_generator)
            for k, v in aux.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return False
        metrics = {f"val/{k}": v / n for k, v in totals.items()}
        if cfg.visualize_denoise_sigmas:
            # JAX's `train/loop.py:243-250`: the EMA weights on the first
            # validation batch, one metric per sigma
            batch0 = self._prep(next(iter(datamodule.val_batches())))
            per_sigma = visualize_denoise_metrics(
                denoiser, state.ema, batch0,
                sigmas=cfg.visualize_denoise_sigmas, mesh=self._dp_mesh,
            )
            for sigma, aux in per_sigma.items():
                metrics[f"val/scaled_rmsd_sigma{sigma}"] = aux["scaled_rmsd"]
        if self.writer:
            self.logger.log_metrics(metrics, state.step)
            self.ckpt.save(state, state.step, metrics)
        if cfg.check_finite and not math.isfinite(metrics.get("val/loss", 0.0)):
            log.error("non-finite validation loss at step %d; stopping", state.step)
            return True
        return False
