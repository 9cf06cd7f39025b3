"""LR schedule multipliers for `torch.optim.lr_scheduler.LambdaLR`
(counterpart of `jamun_tpu/train/lr_schedules.py`). Each maps the step to
the factor on the base learning rate, computed in f32 as the JAX functions
compute it."""

from __future__ import annotations

import numpy as np

__all__ = ["linear", "linear_warmup_linear_decay", "linear_warmup_plateau"]

_f32 = np.float32


def linear(total_steps: int):
    def fn(step):
        return float(_f32(1.0) - _f32(min(step, total_steps)) / _f32(total_steps))

    return fn


def linear_warmup_linear_decay(warmup_steps: int, total_steps: int):
    def fn(step):
        s = _f32(step)
        if s < warmup_steps:
            v = s / _f32(max(warmup_steps, 1))
        else:
            v = (_f32(total_steps) - s) / _f32(max(total_steps - warmup_steps, 1))
        return float(np.clip(v, _f32(0.0), _f32(1.0)))

    return fn


def linear_warmup_plateau(warmup_steps: int):
    def fn(step):
        return float(np.clip(_f32(step) / _f32(max(warmup_steps, 1)), _f32(0.0), _f32(1.0)))

    return fn
