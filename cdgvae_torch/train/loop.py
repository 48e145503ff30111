"""Epoch drivers and the console line (port of ``cdgvae_tpu/train/
loop.py:17-64,103-179``).

``run_epochs`` is the port's ``run_scanned_chunks``: the fixed-shape
epoch runner (``train/scanned.py``), the batch size clamped to the
dataset, ``on_epoch`` after every epoch and ``post_epoch`` only on the
epochs where ``post_epoch_pred`` holds. The JAX driver splits its
multi-epoch dispatches at those epochs so the callback sees the exact
post-epoch state; the port syncs once per epoch anyway, so every epoch
ends a "chunk". Epoch e shuffles and draws its noise from a generator
derived from ``(seed, e)``, so a run resumed at epoch k continues as the
uninterrupted run would.

``train_epoch`` is the eager per-batch protocol (``--eager``): a numpy
shuffle, the last partial batch kept.
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from ..utils.simulation import EPOCH, derived_generator
from .scanned import Averager, make_epoch_runner


def format_epoch(epoch: int, metrics: dict) -> str:
    """The reference's console line format."""
    body = "".join(f", {k}: {v:.4f}" for k, v in metrics.items())
    return f"[epoch {epoch + 1:03d}]{body}"


def batch_indices(n: int, batch_size: int, shuffle_rng: np.random.Generator
                  ) -> Iterator[np.ndarray]:
    """Shuffled batch indices; the final partial batch is kept."""
    perm = shuffle_rng.permutation(n)
    for i in range(0, n, batch_size):
        yield perm[i: i + batch_size]


def train_epoch(step: Callable, x, y, batch_size: int,
                generator: torch.Generator,
                shuffle_rng: np.random.Generator) -> dict:
    """One epoch of ``step(x, y, generator=...)`` over batches from
    :func:`batch_indices`; returns the epoch-mean metrics (keys sorted)."""
    avg = Averager()
    for idx in batch_indices(len(x), batch_size, shuffle_rng):
        idx = torch.as_tensor(idx, device=x.device)
        avg.add(step(x[idx], y[idx], generator=generator))
    return avg.result()


def run_epochs(step: Callable, x, y, *, seed: int, epochs: int,
               batch_size: int, start_epoch: int = 0,
               on_epoch: Callable | None = None,
               post_epoch: Callable | None = None,
               post_epoch_pred: Callable | None = None) -> list[dict]:
    """Train epochs ``start_epoch .. epochs - 1``. ``on_epoch(epoch,
    metrics)`` gets host floats after each; ``post_epoch(epoch)`` runs
    after it on the epochs where ``post_epoch_pred(epoch)`` is true (every
    epoch without a predicate), when the model and optimizer that ``step``
    updates in place hold the exact post-epoch state. A dataset smaller
    than ``batch_size`` trains one full-dataset step per epoch. Returns
    the per-epoch metric dicts."""
    run = make_epoch_runner(step, batch_size=min(batch_size, len(x)))
    history = []
    for epoch in range(start_epoch, epochs):
        metrics = run(x, y, derived_generator(seed, EPOCH, epoch,
                                              device=x.device))
        if on_epoch is not None:
            on_epoch(epoch, metrics)
        history.append(metrics)
        if post_epoch is not None and (post_epoch_pred is None
                                       or post_epoch_pred(epoch)):
            post_epoch(epoch)
    return history
