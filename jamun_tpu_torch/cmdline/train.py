"""`jamun-tpu-torch-train`: the config-driven training entry point
(counterpart of `jamun_tpu/cmdline/train.py`).

    python -m jamun_tpu_torch.cmdline.train experiment=<name> [overrides]

composes the port's `config/defaults/train.yaml` with
`configs/experiment/<name>.yaml` and the overrides, reads the datasets,
computes the normalization pre-pass, builds the denoiser and the optimizer
and runs `Trainer.fit` (with `resume_from_checkpoint`), writing the run
directory `runs/<run_key>/` as JAX's CLI does: `config.pkl`, `config.yaml`,
`checkpoints/` (`last.ckpt`, `step<N>.ckpt`, `manifest.json`),
`metrics.csv` and `diagnostics/`. The model, the state and every batch go to
the override `device` (`device=cpu` runs on the CPU); without it, the card.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import pickle

import numpy as np
import torch
import yaml

from jamun_tpu_torch.cmdline.common import build_denoiser, build_optimizer, setup_logging
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.data.datamodule import DataModule
from jamun_tpu_torch.models.denoiser import Denoiser
from jamun_tpu_torch.train.loggers import ConsoleLogger, CSVLogger, MultiLogger, maybe_wandb_logger
from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
from jamun_tpu_torch.train.state import TrainState
from jamun_tpu_torch.utils.average_squared_distance import compute_average_squared_distance_from_datasets
from jamun_tpu_torch.utils.device import resolve_device
from jamun_tpu_torch.utils.equivariance import assert_arch_equivariant

log = logging.getLogger("jamun_tpu_torch")

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "defaults")


def equivariance_self_test(denoiser: Denoiser, datamodule: DataModule, device) -> float:
    """`model.test_equivariance`: the arch on the first training batch, its
    scalar parameters raised by 0.5 (a fresh arch's zero output gain would
    make the check vacuous), against a rotated and shifted copy."""
    batch0 = next(iter(datamodule.train_batches(0))).to_device(device)
    arch0 = copy.deepcopy(denoiser.arch)
    with torch.no_grad():
        for p in arch0.parameters():
            if p.ndim == 0:
                p.add_(0.5)
    c_noise = torch.tensor([np.log(0.04) / 4.0], dtype=torch.float32, device=device)
    cutoff = denoiser.effective_radial_cutoff(0.04)
    return assert_arch_equivariant(lambda b: arch0(b, c_noise, cutoff), batch0)


def run(cfg) -> TrainState:
    device = resolve_device(cfg.get("device"))
    datasets = instantiate(cfg["data"]["datasets"])
    val_cfg = cfg["data"].get("val_datasets")
    val_datasets = instantiate(val_cfg) if val_cfg else []

    dm_cfg = dict(cfg["data"]["datamodule"])
    dm_cfg.pop("_target_", None)
    datamodule = DataModule(datasets=datasets, val_datasets=val_datasets, **dm_cfg)

    asd = cfg["model"].get("average_squared_distance")
    if asd is None and cfg.get("compute_average_squared_distance", True):
        cutoff = float(cfg["model"].get("max_radius") or 1.0)
        asd = compute_average_squared_distance_from_datasets(datasets, cutoff)
        log.info("computed average_squared_distance=%.6f", asd)

    trainer_cfg = dict(cfg["trainer"])
    trainer_cfg.pop("_target_", None)
    trainer_cfg["ema_decay"] = cfg["model"].get("ema_decay", trainer_cfg.get("ema_decay", 0.999))
    par = dict(cfg.get("parallel") or {})
    for k in ("atom_sharded", "atom_shard_threshold", "num_devices"):
        if par.get(k) is not None:
            trainer_cfg[k] = par[k]
    tconf = TrainerConfig(**trainer_cfg)

    denoiser = build_denoiser(cfg["model"], asd, device=device, seed=tconf.seed)
    optimizer = build_optimizer(cfg["model"])
    sigma_distribution = instantiate(cfg["model"]["sigma"])

    run_dir = os.path.join("runs", str(cfg.get("run_key", "run")))
    os.makedirs(run_dir, exist_ok=True)
    tconf.checkpoint_dir = os.path.join(run_dir, "checkpoints")

    # the resolved config (with the computed normalization) beside the
    # checkpoints, so that sampling can rebuild the model
    resolved = dict(cfg)
    resolved.setdefault("model", {})
    resolved["model"] = dict(resolved["model"], average_squared_distance=float(asd))
    with open(os.path.join(run_dir, "config.pkl"), "wb") as f:
        pickle.dump(resolved, f)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump({k: v for k, v in resolved.items() if k != "__global_package__"}, f)
    loggers = MultiLogger(
        ConsoleLogger(),
        CSVLogger(run_dir),
        maybe_wandb_logger(cfg.get("wandb_project")),
    )

    if cfg["model"].get("test_equivariance"):
        err = equivariance_self_test(denoiser, datamodule, device)
        log.info("equivariance self-test passed: max error %.2e", err)

    trainer = Trainer(tconf, loggers, device=device)
    log.info("device: %s", torch.cuda.get_device_name(device) if device.type == "cuda" else device)
    return trainer.fit(
        denoiser, optimizer, sigma_distribution, datamodule,
        resume_from=cfg.get("resume_from_checkpoint"),
    )


def main(argv=None) -> TrainState:
    setup_logging()
    parser = argparse.ArgumentParser(description="Train a jamun_tpu_torch denoiser")
    parser.add_argument("--config-dir", default=DEFAULT_CONFIG_DIR)
    parser.add_argument("--config-name", default="train")
    parser.add_argument("--experiment-dir", default="configs/experiment")
    parser.add_argument("overrides", nargs="*", help="key=value overrides / experiment=<name>")
    args = parser.parse_args(argv)
    cfg = compose(args.config_dir, args.config_name, args.overrides, args.experiment_dir)
    try:
        return run(cfg)
    except Exception:
        log.exception("training failed")  # the full traceback in the run's log
        raise


if __name__ == "__main__":
    main()
