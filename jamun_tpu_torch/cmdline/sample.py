"""`jamun-tpu-torch-sample`: walk-jump sampling from a trained checkpoint
(counterpart of `jamun_tpu/cmdline/sample.py`).

    python -m jamun_tpu_torch.cmdline.sample experiment=<name> [overrides]

composes the port's `config/defaults/sample.yaml` with
`configs/experiment/<name>.yaml` and the overrides, finds the checkpoint
(`checkpoint_type`: "best_so_far", "last" or a "*.ckpt" path), rebuilds the
model from the run's `config.pkl`, restores the checkpoint (written by the
port's train CLI or by JAX's), optionally finetunes on the starting frames
(`finetune_on_init`), and samples with the EMA weights through `Sampler`,
writing JAX's layout: `<output_dir>/<label>/predicted_samples/` with
`batch_<b>_graph_<g>.{npy,pdb,dcd}`, `joined_trajectory.dcd` and
`topology.pdb`, `<output_dir>/<label>/samples.html`, and
`<output_dir>/sampling_times.csv`. Everything runs on the override `device`
(`device=cpu` runs on the CPU); without it, the card.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
from typing import Any, Dict, List

import numpy as np
import torch

from jamun_tpu_torch.analysis.load_trajectory import write_sampling_times_csv
from jamun_tpu_torch.cmdline.common import build_denoiser, build_optimizer, setup_logging
from jamun_tpu_torch.config.compose import compose
from jamun_tpu_torch.config.instantiate import instantiate
from jamun_tpu_torch.data.batching import collate
from jamun_tpu_torch.metrics.base import MeasureSamplingTimeCallback, TrajectoryMetricCallback
from jamun_tpu_torch.metrics.chemical_validity import ChemicalValidityMetrics
from jamun_tpu_torch.metrics.ramachandran import RamachandranMetrics
from jamun_tpu_torch.metrics.save_trajectory import SaveTrajectory
from jamun_tpu_torch.metrics.score_distribution import ScoreDistributionMetrics
from jamun_tpu_torch.metrics.visualize import SampleVisualizer
from jamun_tpu_torch.models.denoiser import Denoiser
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.sampling.sampler import Sampler
from jamun_tpu_torch.train.checkpoints import find_checkpoint, restore_checkpoint
from jamun_tpu_torch.train.distributions import ConstantSigma
from jamun_tpu_torch.train.state import TrainState, create_train_state, make_train_step
from jamun_tpu_torch.utils.device import resolve_device

log = logging.getLogger("jamun_tpu_torch")

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "defaults")

# the only globals a plain config dict may name in its pickle
_PICKLE_BUILTINS = frozenset({"set", "frozenset", "complex"})


class _PlainUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in ("builtins", "__builtin__") and name in _PICKLE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"config.pkl names {module}.{name}; the port reads a plain dict of builtin values only"
        )


def load_config_pickle(path: str) -> Dict[str, Any]:
    """A run's `config.pkl` (JAX's train CLI and the port's both pickle a
    plain dict). Any class the pickle names raises: one that names a
    `jamun_tpu` class would otherwise import JAX."""
    with open(path, "rb") as f:
        return _PlainUnpickler(f).load()


def get_initial_graphs(datasets, num_init_samples: int, repeat: int, seed: int = 0):
    """Starting structures: `num_init_samples` frames per dataset, each
    repeated `repeat` times; the same numpy draw as JAX, so the same frames.
    Returns (the collated batch, each graph's dataset index)."""
    rng = np.random.default_rng(seed)
    items, graph_to_dataset = [], []
    for d_i, ds in enumerate(datasets):
        idx = rng.choice(len(ds), size=min(num_init_samples, len(ds)), replace=False)
        for i in idx:
            for _ in range(repeat):
                items.append(ds[int(i)])
                graph_to_dataset.append(d_i)
    return collate(items), graph_to_dataset


def apply_arch_kernel_defaults(cfg, model_cfg, on_card: bool) -> None:
    """The kernel switches of an E3Conv arch for sampling (mutates
    `model_cfg["arch"]`; other archs are left as they are). JAX's rule, with
    "on the TPU" read as "on the card":

      - `use_pallas` defaults to on on the card and off on the CPU, where it
        means `plain=True`, the reference path;
      - `fused_stack` (the whole-model kernel K3, forward only) defaults to
        on only on the card and without `finetune_on_init`, which
        differentiates the network;
      - an explicit `use_pallas` / `fused_stack` in the sample config wins;
        `use_pallas=false` on the card raises, since the card runs the
        kernels (the port's device rule)."""
    arch_cfg = model_cfg.get("arch")
    if not (isinstance(arch_cfg, dict) and "E3Conv" in str(arch_cfg.get("_target_", ""))):
        return
    arch_cfg["use_pallas"] = bool(cfg.get("use_pallas", on_card))
    if on_card and not arch_cfg["use_pallas"]:
        raise ValueError(
            "use_pallas=false is the CPU reference path (plain=True); the card runs the kernels"
        )
    finetunes = (cfg.get("finetune_on_init") or {}).get("num_steps", 0) > 0
    arch_cfg["fused_stack"] = bool(
        cfg.get("fused_stack", arch_cfg["use_pallas"] and on_card and not finetunes)
    )


def finetune_on_init(
    denoiser: Denoiser, state: TrainState, init_graphs: GraphBatch, ft: Dict[str, Any], sigma: float
) -> List[float]:
    """`ft["num_steps"]` train steps on the starting frames at the constant
    `sigma`, EMA decay `ft["ema_decay"]` (default 0.999), the loss logged
    every `ft["log_every"]` steps (each logged step reads the loss).
    Returns the logged losses."""
    step_fn = make_train_step(
        denoiser, ConstantSigma(float(sigma)), ema_decay=float(ft.get("ema_decay", 0.999))
    )
    every = max(int(ft.get("log_every", 10)), 1)
    losses = []
    for i in range(int(ft["num_steps"])):
        state, aux = step_fn(state, init_graphs)
        if i % every == 0:
            losses.append(float(aux["loss"]))
            log.info("finetune step %d: loss=%.5f", i, losses[-1])
    return losses


class _AllMetricsCallback(TrajectoryMetricCallback):
    """Routes each sampled graph to every metric of its dataset; at the end
    computes every metric and keeps the union of their results per label."""

    def __init__(self, metrics_per_dataset, graph_to_dataset, labels):
        super().__init__([m for ms in metrics_per_dataset for m in ms])
        self.metrics_per_dataset = metrics_per_dataset
        self.graph_to_dataset = graph_to_dataset
        self.labels = labels

    def on_after_sample_batch(self, sample, sampler, **kwargs):
        for s in sample:
            for m in self.metrics_per_dataset[self.graph_to_dataset[s.get("graph_index", 0)]]:
                m.update(s)

    def on_sample_end(self, sampler, **kwargs):
        for label, ms in zip(self.labels, self.metrics_per_dataset):
            for m in ms:
                result = m.compute()
                self.results.setdefault(label, {}).update(result)
                log.info("metrics[%s] %s: %s", label, type(m).__name__,
                         {k: v for k, v in result.items() if isinstance(v, (int, float, str))})


def run(cfg) -> Dict[str, Any]:
    """The sampling run. Returns {"checkpoint", "state", "denoiser" (the
    sampling denoiser, EMA weights), "finetune_losses", "results" (label ->
    every metric's result), "rates" (the CSV's rows), "per_batch" (the
    timing callback's batches)}."""
    device = resolve_device(cfg.get("device"))
    if cfg.get("init_datasets") is None:
        raise ValueError("init_datasets must be configured for sampling")
    datasets = instantiate(cfg["init_datasets"])
    labels = [ds.label() for ds in datasets]

    init_graphs, graph_to_dataset = get_initial_graphs(
        datasets,
        cfg.get("num_init_samples_per_dataset", 1),
        cfg.get("repeat_init_samples", 1),
        seed=cfg.get("seed", 0),
    )
    out_dir = cfg.get("output_dir", "sampler")
    metrics_per_dataset = [
        [
            SaveTrajectory(ds, out_dir),
            RamachandranMetrics(ds),
            ChemicalValidityMetrics(ds),
            ScoreDistributionMetrics(ds),
            SampleVisualizer(ds, out_dir),
        ]
        for ds in datasets
    ]
    metrics_cb = _AllMetricsCallback(metrics_per_dataset, graph_to_dataset, labels)
    timing_cb = MeasureSamplingTimeCallback(label_for_graph=[labels[d] for d in graph_to_dataset])
    par = dict(cfg.get("parallel") or {})
    # several devices and atom sharding raise here, before any work
    sampler = Sampler(
        callbacks=[metrics_cb, timing_cb],
        atom_sharded=par.get("atom_sharded") in (True, "true", "on"),
        num_devices=par.get("num_devices"),
        device=device,
    )

    ckpt_path = find_checkpoint(cfg["checkpoint_dir"], cfg.get("checkpoint_type", "best_so_far"))
    log.info("loading checkpoint %s", ckpt_path)
    # the model from the training config stored beside the checkpoints
    run_dir = os.path.dirname(os.path.dirname(ckpt_path))
    train_cfg_path = os.path.join(run_dir, "config.pkl")
    if os.path.exists(train_cfg_path):
        model_cfg = load_config_pickle(train_cfg_path)["model"]
    else:
        model_cfg = cfg.get("model") or compose(DEFAULT_CONFIG_DIR, "train")["model"]

    # ASD sets the preconditioning constants (c_in, c_skip, c_out): a value
    # other than training's gives wrong samples, so it is never defaulted
    asd = model_cfg.get("average_squared_distance")
    if asd is None:
        asd = cfg.get("average_squared_distance")
    if asd is None:
        raise ValueError(
            "average_squared_distance used at training time could not be recovered "
            f"(no config.pkl next to {ckpt_path} and no model.average_squared_distance "
            "in the sampling config); pass average_squared_distance=<value> explicitly."
        )
    apply_arch_kernel_defaults(cfg, model_cfg, on_card=device.type == "cuda")

    denoiser = build_denoiser(model_cfg, float(asd), device=device, seed=0)
    state = create_train_state(denoiser, build_optimizer(model_cfg), seed=0, device=device)
    restore_checkpoint(ckpt_path, state)

    ft = cfg.get("finetune_on_init") or {}
    losses = []
    if ft.get("num_steps", 0) > 0:
        losses = finetune_on_init(
            denoiser, state, init_graphs.to_device(device), ft, cfg.get("sigma", 0.04)
        )

    sampling_denoiser = Denoiser(state.ema, denoiser.config)  # sample with the EMA weights
    batch_sampler = instantiate(cfg["batch_sampler"])
    log.info("device: %s", torch.cuda.get_device_name(device) if device.type == "cuda" else device)
    # one card: process index 0 (JAX adds jax.process_index())
    sampler.sample(
        sampling_denoiser,
        batch_sampler,
        num_batches=cfg.get("num_batches", 5),
        init_graphs=init_graphs,
        continue_chain=cfg.get("continue_chain", True),
        seed=int(cfg.get("seed", 0)),
    )

    rows = {}
    if timing_cb.total_samples:
        # per label, the warm rate first (batch 0 carries the kernels' build)
        rows = timing_cb.rates()
        if timing_cb.last_neighbor_overflow is not None:
            for r in rows.values():
                r["neighbor_overflow_mean"] = timing_cb.last_neighbor_overflow["mean"]
                r["neighbor_overflow_max"] = timing_cb.last_neighbor_overflow["max"]
        write_sampling_times_csv(os.path.join(out_dir, "sampling_times.csv"), rows)
    return dict(
        checkpoint=ckpt_path, state=state, denoiser=sampling_denoiser, finetune_losses=losses,
        results=metrics_cb.results, rates=rows, per_batch=timing_cb.per_batch,
    )


def main(argv=None) -> Dict[str, Any]:
    setup_logging()
    parser = argparse.ArgumentParser(description="Walk-jump sampling with a trained denoiser")
    parser.add_argument("--config-dir", default=DEFAULT_CONFIG_DIR)
    parser.add_argument("--config-name", default="sample")
    parser.add_argument("--experiment-dir", default="configs/experiment")
    parser.add_argument("overrides", nargs="*", help="key=value overrides / experiment=<name>")
    args = parser.parse_args(argv)
    cfg = compose(args.config_dir, args.config_name, args.overrides, args.experiment_dir)
    try:
        return run(cfg)
    except Exception:
        log.exception("sampling failed")  # the full traceback in the run's log
        raise


if __name__ == "__main__":
    main()
