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

The port runs on one card: `num_devices` above 1 and `atom_sharded=True`
raise (ROADMAP.md queue A, 'Parallel'); "auto" is a no-op. There is no
counterpart of JAX's kernel fallback (`step_with_fallback`): a step that
fails (a kernel that does not build or launch, a shape outside the kernels)
raises out of `fit`.
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
    num_devices: Optional[int] = None  # one card: None or 1
    atom_sharded: object = "auto"  # one card: "auto" or False
    atom_shard_threshold: int = 1024
    seed: int = 0
    collect_sigma_diagnostics: bool = True  # sigma against loss and grad norm, a CSV per epoch
    visualize_denoise_sigmas: tuple = ()  # per-sigma denoise metrics at each validation


class Trainer:
    """`device` follows `utils.device.resolve_device` (the card unless
    "cpu"); the module, the state and every batch go there (a batch through
    `GraphBatch.to_device`: from page-locked host memory without a wait)."""

    def __init__(self, config: TrainerConfig, loggers=None, device=None):
        if config.num_devices not in (None, 1) or config.atom_sharded is True:
            raise NotImplementedError(
                f"num_devices={config.num_devices}, atom_sharded={config.atom_sharded}: training "
                "on several devices is not ported (ROADMAP.md queue A, 'Parallel')"
            )
        self.config = config
        self.device = resolve_device(device)
        self.logger = loggers or MultiLogger(ConsoleLogger(every_n=1))
        self.ckpt = CheckpointManager(config.checkpoint_dir, top_k=config.checkpoint_top_k)
        self.diagnostics = (
            SigmaDistributionDiagnostics(os.path.join(config.checkpoint_dir, "..", "diagnostics"))
            if config.collect_sigma_diagnostics
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
        state = create_train_state(denoiser, optimizer, seed=cfg.seed, device=self.device)
        if resume_from:
            restore_checkpoint(resume_from, state)
            log.info("resumed from %s at step %d", resume_from, state.step)
        train_step = make_train_step(denoiser, sigma_distribution, cfg.ema_decay)
        eval_step = make_eval_step(denoiser, sigma_distribution)

        samples_seen = 0
        t_start = time.perf_counter()
        stop = False
        for epoch in range(cfg.max_epochs):
            if stop:
                break
            for batch in datamodule.train_batches(epoch):
                batch = batch.to_device(self.device)
                state, aux = train_step(state, batch)
                step = state.step
                samples_seen += batch.pos.shape[0]
                if step % cfg.log_every_n_steps == 0:
                    host_aux = {k: float(v) for k, v in aux.items()}
                    if self.diagnostics:
                        self.diagnostics.update(host_aux, step)
                    metrics = {f"train/{k}": v for k, v in host_aux.items()}
                    elapsed = time.perf_counter() - t_start
                    metrics["train/samples_per_sec"] = samples_seen / elapsed
                    metrics["train/steps_per_sec"] = step / elapsed
                    metrics["epoch"] = epoch
                    self.logger.log_metrics(metrics, step)
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
        self.logger.finalize()
        return state

    def _validate(self, state: TrainState, eval_step, datamodule, denoiser: Denoiser) -> bool:
        """Logs val/* averaged over batches and saves a checkpoint; True when
        training should stop (a non-finite loss)."""
        cfg = self.config
        seed = cfg.seed + state.step
        generator = torch.Generator(device=self.device).manual_seed(seed)
        host_generator = torch.Generator().manual_seed(seed)
        totals: Dict[str, float] = {}
        n = 0
        for batch in datamodule.val_batches():
            if n >= cfg.val_max_batches:
                break
            aux = eval_step(state, batch.to_device(self.device), generator, host_generator)
            for k, v in aux.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return False
        metrics = {f"val/{k}": v / n for k, v in totals.items()}
        if cfg.visualize_denoise_sigmas:
            # JAX's `train/loop.py:243-250`: the EMA weights on the first
            # validation batch, one metric per sigma
            batch0 = next(iter(datamodule.val_batches())).to_device(self.device)
            per_sigma = visualize_denoise_metrics(
                denoiser, state.ema, batch0, sigmas=cfg.visualize_denoise_sigmas
            )
            for sigma, aux in per_sigma.items():
                metrics[f"val/scaled_rmsd_sigma{sigma}"] = aux["scaled_rmsd"]
        self.logger.log_metrics(metrics, state.step)
        self.ckpt.save(state, state.step, metrics)
        if cfg.check_finite and not math.isfinite(metrics.get("val/loss", 0.0)):
            log.error("non-finite validation loss at step %d; stopping", state.step)
            return True
        return False
