"""Epoch loop and console line (port of ``cdgvae_tpu/train/loop.py``:
``format_epoch`` at :103-106 and the batch-size clamp of
``run_scanned_chunks`` at :140-143)."""
from __future__ import annotations

from typing import Callable

import torch

from .scanned import make_epoch_runner


def format_epoch(epoch: int, metrics: dict) -> str:
    """The reference's console line format."""
    body = "".join(f", {k}: {v:.4f}" for k, v in metrics.items())
    return f"[epoch {epoch + 1:03d}]{body}"


def run_epochs(step: Callable, x, y, generator: torch.Generator, *,
               epochs: int, batch_size: int,
               on_epoch: Callable | None = None) -> list[dict]:
    """Train ``epochs`` epochs; ``on_epoch(epoch, metrics)`` is called after
    each with host floats. A dataset smaller than ``batch_size`` trains one
    full-dataset step per epoch. Returns the per-epoch metric dicts."""
    run = make_epoch_runner(step, batch_size=min(batch_size, len(x)))
    history = []
    for epoch in range(epochs):
        metrics = run(x, y, generator)
        if on_epoch is not None:
            on_epoch(epoch, metrics)
        history.append(metrics)
    return history
