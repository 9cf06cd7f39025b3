"""Shared CLI helpers: config -> the port's objects (counterpart of
`jamun_tpu/cmdline/common.py`)."""

from __future__ import annotations

import functools
import logging
import os
from typing import Any, Dict, Optional

from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig

log = logging.getLogger("jamun_tpu_torch")


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level, format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s"
    )
    load_dotenv()


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader: KEY=VALUE lines populate os.environ without
    overriding existing values."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            os.environ.setdefault(key.strip(), value.strip().strip('"').strip("'"))


def denoiser_config(
    model_cfg: Dict[str, Any], average_squared_distance: Optional[float] = None
) -> DenoiserConfig:
    asd = average_squared_distance
    if asd is None:
        asd = model_cfg.get("average_squared_distance")
    if asd is None:
        raise ValueError("average_squared_distance not set (enable compute_average_squared_distance)")
    return DenoiserConfig(
        max_radius=float(model_cfg.get("max_radius") or 1.0),
        average_squared_distance=float(asd),
        align_noisy_input_during_training=model_cfg.get("align_noisy_input_during_training", True),
        align_noisy_input_during_evaluation=model_cfg.get("align_noisy_input_during_evaluation", True),
        mean_center=model_cfg.get("mean_center", True),
        mirror_augmentation_rate=model_cfg.get("mirror_augmentation_rate", 0.0),
        add_fixed_noise=model_cfg.get("add_fixed_noise", False),
        add_fixed_ones=model_cfg.get("add_fixed_ones", False),
        bond_loss_coefficient=model_cfg.get("bond_loss_coefficient", 1.0),
    )


def build_denoiser(
    model_cfg: Dict[str, Any], average_squared_distance: Optional[float] = None, device=None,
    seed: int = 0,
) -> Denoiser:
    """The denoiser around `model.arch`, built on `device` (the card unless
    "cpu") with its parameters drawn from `seed`."""
    config = denoiser_config(model_cfg, average_squared_distance)
    return Denoiser(instantiate(model_cfg["arch"], device=device, seed=seed), config)


def build_optimizer(model_cfg: Dict[str, Any]):
    """`model.optim` (a `_partial_` factory of `train/optim.py`), with
    `model.lr_scheduler` chained after it when set, as JAX chains
    `optax.scale_by_schedule`: a callable `params -> torch optimizer`."""
    optimizer = instantiate(model_cfg["optim"])()
    lr_sched_cfg = model_cfg.get("lr_scheduler")
    if lr_sched_cfg:
        optimizer = functools.partial(optimizer, schedule=instantiate(lr_sched_cfg))
    return optimizer
