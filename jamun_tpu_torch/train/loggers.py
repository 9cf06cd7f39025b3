"""Metric loggers: console and CSV, and wandb where it is installed and a
project is named (counterpart of `jamun_tpu/train/loggers.py`, the same
behaviour: without wandb a warning, and no wandb logger)."""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, Optional

__all__ = ["CSVLogger", "ConsoleLogger", "MultiLogger", "maybe_wandb_logger"]

log = logging.getLogger("jamun_tpu_torch")


class CSVLogger:
    def __init__(self, directory: str, name: str = "metrics.csv"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, name)
        self._fieldnames = None
        self._fh = None

    def log_metrics(self, metrics: Dict[str, float], step: int):
        row = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        if self._fh is None or any(k not in self._fieldnames for k in row):
            old_rows = []
            if self._fh is not None:
                self._fh.close()
                with open(self.path) as f:
                    old_rows = list(csv.DictReader(f))
            self._fieldnames = sorted(set(list(row) + (list(old_rows[0]) if old_rows else [])))
            self._fh = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._fh, fieldnames=self._fieldnames, restval="")
            self._writer.writeheader()
            for r in old_rows:
                self._writer.writerow(r)
        self._writer.writerow(row)
        self._fh.flush()

    def finalize(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class ConsoleLogger:
    def __init__(self, every_n: int = 1):
        self.every_n = every_n

    def log_metrics(self, metrics: Dict[str, float], step: int):
        if step % self.every_n == 0:
            parts = " ".join(f"{k}={float(v):.5g}" for k, v in sorted(metrics.items()))
            log.info("step %d: %s", step, parts)

    def finalize(self):
        pass


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log_metrics(self, metrics, step):
        for l in self.loggers:
            l.log_metrics(metrics, step)

    def finalize(self):
        for l in self.loggers:
            l.finalize()


def maybe_wandb_logger(project: Optional[str] = None, **kwargs):
    if project is None:
        return None
    try:
        import wandb
    except ImportError:
        log.warning("wandb not installed; skipping wandb logger")
        return None

    run = wandb.init(project=project, **kwargs)

    class _WandbLogger:
        def log_metrics(self, metrics, step):
            run.log(dict(metrics), step=step)

        def finalize(self):
            run.finish()

    return _WandbLogger()
