"""Metric logging: terminal + CSV + optional wandb, with filters.

The reference logger stack (reference vnl_ray/default_logger.py: acme
Dispatcher -> NoneFilter -> TimeFilter over terminal/CSV/WandB sinks)
without the acme dependency; pure Python.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Callable, Sequence


class TerminalLogger:
    def __init__(self, label: str = ""):
        self.label = label

    def write(self, values: dict):
        items = ", ".join(f"{k}={_fmt(v)}" for k, v in sorted(values.items()))
        print(f"[{self.label}] {items}", flush=True)

    def close(self):
        pass


def _fmt(v):
    try:
        f = float(v)
        return f"{f:.4g}"
    except (TypeError, ValueError):
        return str(v)


class CSVLogger:
    def __init__(self, directory: str, label: str = "logs"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{label}.csv")
        self._file = None
        self._writer = None

    def write(self, values: dict):
        values = {k: _fmt(v) for k, v in values.items()}
        if self._writer is None:
            self._file = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._file,
                                          fieldnames=sorted(values))
            if self._file.tell() == 0:
                self._writer.writeheader()
        row = {k: values.get(k, "") for k in self._writer.fieldnames}
        self._writer.writerow(row)
        self._file.flush()

    def close(self):
        if self._file:
            self._file.close()


class WandbLogger:
    """Optional Weights & Biases sink (gated import)."""

    def __init__(self, **init_kwargs):
        import wandb  # noqa: F401 (optional dependency)
        self._wandb = wandb
        self._run = wandb.init(**init_kwargs)

    def write(self, values: dict):
        self._wandb.log(values)

    def close(self):
        self._run.finish()


class NoneFilter:
    def __init__(self, inner):
        self.inner = inner

    def write(self, values: dict):
        self.inner.write({k: v for k, v in values.items() if v is not None})

    def close(self):
        self.inner.close()


class TimeFilter:
    """Rate-limit writes to once per `time_delta` seconds."""

    def __init__(self, inner, time_delta: float = 1.0):
        self.inner = inner
        self.time_delta = time_delta
        self._last = 0.0

    def write(self, values: dict):
        now = time.time()
        if now - self._last >= self.time_delta:
            self._last = now
            self.inner.write(values)

    def close(self):
        self.inner.close()


class Dispatcher:
    def __init__(self, loggers: Sequence):
        self.loggers = list(loggers)

    def write(self, values: dict):
        for lg in self.loggers:
            lg.write(values)

    def close(self):
        for lg in self.loggers:
            lg.close()


def make_default_logger(label: str, save_csv: bool = False,
                        csv_dir: str = "logs", use_wandb: bool = False,
                        wandb_kwargs: dict | None = None,
                        time_delta: float = 0.0):
    """Terminal (+CSV, +wandb) dispatcher with None/time filtering
    (reference make_default_logger)."""
    sinks = [TerminalLogger(label)]
    if save_csv:
        sinks.append(CSVLogger(csv_dir, label))
    if use_wandb:
        sinks.append(WandbLogger(**(wandb_kwargs or {})))
    logger = Dispatcher(sinks)
    logger = NoneFilter(logger)
    if time_delta > 0:
        logger = TimeFilter(logger, time_delta)
    return logger
