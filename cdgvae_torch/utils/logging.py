"""Metric logging (port of ``cdgvae_tpu/utils/logging.py:16-75``).

Each ``log`` appends one ``{"time", "step", **metrics}`` record to
``<logdir>/metrics.jsonl``, the JAX package's record shape. wandb is
optional and imported only when asked for; without it the logger writes
the file alone.
"""
from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, logdir: str | None = None, use_wandb: bool = False,
                 project: str = "CausalDisentangled", tags=(), config=None):
        self.logdir = logdir
        self._file = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._file = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None  # not installed: the file sink alone
            if wandb is not None:
                try:
                    self._wandb = wandb.init(project=project,
                                             tags=list(tags), config=config)
                except Exception as e:
                    # a failed login must not stop training, but say so
                    print(f"[MetricLogger] wandb.init failed, continuing "
                          f"without wandb: {e!r}", file=sys.stderr)

    def log(self, metrics: dict, step: int | None = None):
        if self._file:
            rec = {"time": time.time(), "step": step, **metrics}
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, key: str, path: str):
        if self._wandb is not None:
            import wandb
            self._wandb.log({key: wandb.Image(path)})

    def finish(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()
