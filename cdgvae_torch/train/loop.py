"""Epoch drivers and the console line (port of ``cdgvae_tpu/train/
loop.py:17-100,103-191``, with the ``post_update`` hook of ``cdgvae_tpu/
train/scanned.py:287-353``).

``run_epochs`` is the port's ``run_scanned_chunks``: the fixed-shape
epoch runner (``train/scanned.py``), the batch size clamped to the
dataset, ``on_epoch`` after every epoch and ``post_epoch`` only on the
epochs where ``post_epoch_pred`` holds. The JAX driver splits its
multi-epoch dispatches at those epochs so the callback sees the exact
post-epoch state; the port syncs once per epoch anyway, so every epoch
ends a "chunk". Epoch e shuffles and draws its noise from a generator
derived from ``(seed, e)``, so a run resumed at epoch k continues as the
uninterrupted run would.

``train_epoch`` and ``train_epoch_semi`` are the eager per-batch protocol
(``--eager``): a numpy shuffle, the last partial batch kept (dropped by
the CelebA trainer, whose batch-statistics BatchNorms want full batches,
as the JAX package's does).
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from ..utils.simulation import EPOCH, derived_generator
from .scanned import Averager, make_epoch_runner, make_scanned_epochs_semi


def format_epoch(epoch: int, metrics: dict) -> str:
    """The reference's console line format."""
    body = "".join(f", {k}: {v:.4f}" for k, v in metrics.items())
    return f"[epoch {epoch + 1:03d}]{body}"


def batch_indices(n: int, batch_size: int, shuffle_rng: np.random.Generator,
                  drop_remainder: bool = False) -> Iterator[np.ndarray]:
    """Shuffled batch indices; the final partial batch is kept unless
    ``drop_remainder``."""
    perm = shuffle_rng.permutation(n)
    end = n - n % batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        yield perm[i: i + batch_size]


def train_epoch(step: Callable, x, y, batch_size: int,
                generator: torch.Generator,
                shuffle_rng: np.random.Generator,
                post_update: Callable | None = None,
                drop_remainder: bool = False) -> dict:
    """One epoch of ``step(x, y, generator=...)`` over batches from
    :func:`batch_indices`, each followed by ``post_update()`` when given;
    returns the epoch-mean metrics (keys sorted)."""
    avg = Averager()
    for idx in batch_indices(len(x), batch_size, shuffle_rng,
                             drop_remainder):
        idx = torch.as_tensor(idx, device=x.device)
        avg.add(step(x[idx], y[idx], generator=generator))
        if post_update is not None:
            post_update()
    return avg.result()


def train_epoch_semi(step: Callable, x_u, x_l, y_l, batch_size: int,
                     batch_size_l: int, generator: torch.Generator,
                     shuffle_rng: np.random.Generator) -> dict:
    """One semi-supervised epoch of ``step(x_u, x_l, y_l, generator=...)``
    over the unlabeled batches, cycling the labeled ones with a reshuffle
    when they run out; short batches are kept. As in the reference each
    permutation is drawn from ``shuffle_rng`` at its stream's first batch:
    the unlabeled one, then the labeled one, then each labeled reshuffle.
    Returns the epoch-mean metrics (keys sorted)."""
    avg = Averager()
    labeled_iter = batch_indices(len(x_l), batch_size_l, shuffle_rng)
    for idx_u in batch_indices(len(x_u), batch_size, shuffle_rng):
        try:
            idx_l = next(labeled_iter)
        except StopIteration:
            labeled_iter = batch_indices(len(x_l), batch_size_l, shuffle_rng)
            idx_l = next(labeled_iter)
        idx_u = torch.as_tensor(idx_u, device=x_u.device)
        idx_l = torch.as_tensor(idx_l, device=x_l.device)
        avg.add(step(x_u[idx_u], x_l[idx_l], y_l[idx_l], generator=generator))
    return avg.result()


def _drive(run: Callable, data: tuple, *, seed: int, epochs: int,
           start_epoch: int, on_epoch: Callable | None,
           post_epoch: Callable | None,
           post_epoch_pred: Callable | None) -> list[dict]:
    """Epochs ``start_epoch .. epochs - 1`` of ``run(*data, generator)``,
    each with the generator derived from ``(seed, epoch)``."""
    history = []
    for epoch in range(start_epoch, epochs):
        metrics = run(*data, derived_generator(seed, EPOCH, epoch,
                                               device=data[0].device))
        if on_epoch is not None:
            on_epoch(epoch, metrics)
        history.append(metrics)
        if post_epoch is not None and (post_epoch_pred is None
                                       or post_epoch_pred(epoch)):
            post_epoch(epoch)
    return history


def run_epochs(step: Callable, x, y, *, seed: int, epochs: int,
               batch_size: int, start_epoch: int = 0,
               on_epoch: Callable | None = None,
               post_epoch: Callable | None = None,
               post_epoch_pred: Callable | None = None,
               post_update: Callable | None = None) -> list[dict]:
    """Train epochs ``start_epoch .. epochs - 1``. ``on_epoch(epoch,
    metrics)`` gets host floats after each; ``post_epoch(epoch)`` runs
    after it on the epochs where ``post_epoch_pred(epoch)`` is true (every
    epoch without a predicate), when the model and optimizer that ``step``
    updates in place hold the exact post-epoch state; ``post_update()``
    runs after every step, the counterpart of the JAX trainers'
    ``post_update`` (the TVAE's sigma clamp). A dataset smaller than
    ``batch_size`` trains one full-dataset step per epoch. Returns the
    per-epoch metric dicts. The InfoMax step updates its model and
    discriminator in place, so it runs here as any step does."""
    run = make_epoch_runner(step, batch_size=min(batch_size, len(x)),
                            post_update=post_update)
    return _drive(run, (x, y), seed=seed, epochs=epochs,
                  start_epoch=start_epoch, on_epoch=on_epoch,
                  post_epoch=post_epoch, post_epoch_pred=post_epoch_pred)


def run_epochs_semi(step: Callable, x_u, x_l, y_l, *, seed: int,
                    epochs: int, batch_size: int, batch_size_l: int,
                    start_epoch: int = 0,
                    on_epoch: Callable | None = None) -> list[dict]:
    """:func:`run_epochs` for the two-stream semi-supervised runner
    (``train/scanned.py::make_scanned_epochs_semi``), each batch size
    clamped to its stream."""
    run = make_scanned_epochs_semi(step, min(batch_size, len(x_u)),
                                   min(batch_size_l, len(x_l)))
    return _drive(run, (x_u, x_l, y_l), seed=seed, epochs=epochs,
                  start_epoch=start_epoch, on_epoch=on_epoch,
                  post_epoch=None, post_epoch_pred=None)
