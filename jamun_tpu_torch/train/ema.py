"""Exponential moving average of parameters (counterpart of
`jamun_tpu/train/ema.py`): ema = decay * ema + (1 - decay) * p.

Unlike the JAX transform, `ema_update` updates the EMA tensors in place
(one fused multi-tensor multiply and add), so the EMA copy costs one set of
parameters and no allocation per step."""

from __future__ import annotations

import copy
from typing import List

import torch
from torch import nn

__all__ = ["ema_init", "ema_update"]


def ema_init(module: nn.Module) -> nn.Module:
    """A frozen copy of `module` (same device, same values)."""
    ema = copy.deepcopy(module)
    ema.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    """In place: each ema tensor becomes decay * ema + (1 - decay) * p."""
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, [p.detach() for p in params], alpha=1.0 - decay)
