"""The training loop (counterpart of `jamun_tpu/train/loop.py`, the fields
this slice uses): steps over an iterable of `GraphBatch`es, logs every
`log_every_n_steps`, validates on the EMA weights every `val_every_n_steps`
(or once at the end), and stops on a non-finite validation loss when
`check_finite` is set.

There is no fallback: a step that fails (a kernel that does not build or
launch, a shape outside the kernels) raises out of `fit`. Checkpoints,
loggers, sigma diagnostics and the data module come in later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from jamun_tpu_torch.models.denoiser import Denoiser
from jamun_tpu_torch.ops.graph import GraphBatch
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
    max_steps: int = 1000
    log_every_n_steps: int = 50
    val_every_n_steps: Optional[int] = None  # None: validate once, at the end
    val_max_batches: int = 50
    learning_rate: float = 2.0e-3
    ema_decay: float = 0.999
    check_finite: bool = True  # stop on a non-finite validation loss
    seed: int = 0


class Trainer:
    """`Trainer(config, denoiser, sigma_distribution).fit(train, val)`.
    `device` follows `utils.device.resolve_device` (the card unless "cpu");
    batches are moved there (`GraphBatch.to_device`: from pinned host memory
    without a wait). `metrics` keeps every logged (step, dict)."""

    def __init__(
        self, config: TrainerConfig, denoiser: Denoiser, sigma_distribution, lr_lambda=None,
        device=None,
    ):
        self.config = config
        self.denoiser = denoiser
        self.sigma_distribution = sigma_distribution
        self.lr_lambda = lr_lambda
        self.device = resolve_device(device)
        self.metrics: List[Tuple[int, Dict[str, float]]] = []

    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        self.metrics.append((step, metrics))
        log.info("step %d: %s", step, " ".join(f"{k}={v:.6g}" for k, v in metrics.items()))

    def fit(
        self, train_batches: Iterable[GraphBatch], val_batches: Optional[Iterable[GraphBatch]] = None
    ) -> TrainState:
        """Train for up to `max_steps` batches of `train_batches`.
        `val_batches` must be re-iterable (a list) when validation runs more
        than once."""
        cfg = self.config
        state = create_train_state(
            self.denoiser, cfg.learning_rate, seed=cfg.seed, lr_lambda=self.lr_lambda,
            device=self.device,
        )
        train_step = make_train_step(self.denoiser, self.sigma_distribution, cfg.ema_decay)
        eval_step = make_eval_step(self.denoiser, self.sigma_distribution)
        t_start = time.perf_counter()
        samples = 0
        for batch in train_batches:
            if state.step >= cfg.max_steps:
                break
            batch = batch.to_device(self.device)
            state, aux = train_step(state, batch)
            samples += batch.pos.shape[0]
            if state.step % cfg.log_every_n_steps == 0:
                metrics = {f"train/{k}": float(v) for k, v in aux.items()}
                elapsed = time.perf_counter() - t_start
                metrics["train/samples_per_sec"] = samples / elapsed
                metrics["train/steps_per_sec"] = state.step / elapsed
                self._log(state.step, metrics)
            if val_batches is not None and cfg.val_every_n_steps and (
                state.step % cfg.val_every_n_steps == 0
            ):
                if self._validate(state, eval_step, val_batches):
                    return state
        if val_batches is not None and not cfg.val_every_n_steps:
            self._validate(state, eval_step, val_batches)
        return state

    def _validate(self, state: TrainState, eval_step, val_batches) -> bool:
        """Logs val/* averaged over batches; True when training should stop."""
        cfg = self.config
        seed = cfg.seed + state.step
        generator = torch.Generator(device=self.device).manual_seed(seed)
        host_generator = torch.Generator().manual_seed(seed)
        totals: Dict[str, float] = {}
        n = 0
        for batch in val_batches:
            if n >= cfg.val_max_batches:
                break
            aux = eval_step(state, batch.to_device(self.device), generator, host_generator)
            for k, v in aux.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return False
        metrics = {f"val/{k}": v / n for k, v in totals.items()}
        self._log(state.step, metrics)
        if cfg.check_finite and not math.isfinite(metrics["val/loss"]):
            log.error("non-finite validation loss at step %d; stopping", state.step)
            return True
        return False
