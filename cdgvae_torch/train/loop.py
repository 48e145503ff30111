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

Under a mesh (``parallel.mesh.Mesh``) ``run_epochs`` and
``run_epochs_semi`` are the sharded trainers: each rank takes its block of
the rows (``parallel.mesh.shard_rows``) and runs the epoch runner at the
local batch size, with a generator derived from ``(seed, epoch, rank)``
(at world size 1 the single-device ``(seed, epoch)``, so a world-1 run
equals a one-device run bit for bit). ``train_epoch`` and
``train_epoch_semi`` under a mesh are the eager protocol of
``cdgvae_tpu/train/steps.py:268-286``: every rank draws the same global
numpy permutation, takes its contiguous slice of each global batch, and
drops the last partial batch; the step averages the gradients.
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from ..parallel.mesh import rank_path, shard_rows, split_batch
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


def _rank_slice(idx: np.ndarray, mesh) -> np.ndarray:
    """This rank's contiguous slice of a global batch."""
    local = len(idx) // mesh.size
    return idx[mesh.rank * local:(mesh.rank + 1) * local]


def _check_full_batch(n: int, batch_size: int, stream: str):
    if n < batch_size:
        raise ValueError(
            f"{stream} ({n}) smaller than batch_size ({batch_size}) with "
            "the last partial batch dropped: every epoch would run zero "
            "steps; lower the batch size")


def train_epoch(step: Callable, x, y, batch_size: int,
                generator: torch.Generator,
                shuffle_rng: np.random.Generator,
                post_update: Callable | None = None,
                drop_remainder: bool = False, mesh=None) -> dict:
    """One epoch of ``step(x, y, generator=...)`` over batches from
    :func:`batch_indices`, each followed by ``post_update()`` when given;
    returns the epoch-mean metrics (keys sorted). Under a ``mesh`` each
    rank steps on its slice of every global batch, the last partial batch
    dropped (module docstring), and the metrics are the cross-rank
    mean."""
    if mesh is not None:
        split_batch(batch_size, mesh)
        drop_remainder = True
        _check_full_batch(len(x), batch_size, "dataset")
    avg = Averager(mesh)
    for idx in batch_indices(len(x), batch_size, shuffle_rng,
                             drop_remainder):
        if mesh is not None:
            idx = _rank_slice(idx, mesh)
        idx = torch.as_tensor(idx, device=x.device)
        avg.add(step(x[idx], y[idx], generator=generator))
        if post_update is not None:
            post_update()
    return avg.result()


def train_epoch_semi(step: Callable, x_u, x_l, y_l, batch_size: int,
                     batch_size_l: int, generator: torch.Generator,
                     shuffle_rng: np.random.Generator, mesh=None) -> dict:
    """One semi-supervised epoch of ``step(x_u, x_l, y_l, generator=...)``
    over the unlabeled batches, cycling the labeled ones with a reshuffle
    when they run out; short batches are kept. As in the reference each
    permutation is drawn from ``shuffle_rng`` at its stream's first batch:
    the unlabeled one, then the labeled one, then each labeled reshuffle.
    Returns the epoch-mean metrics (keys sorted). Under a ``mesh`` both
    streams drop their partial batches and each rank steps on its slice of
    both global batches."""
    drop = mesh is not None
    if drop:
        split_batch(batch_size, mesh)
        split_batch(batch_size_l, mesh, name="batch_sizeL")
        _check_full_batch(len(x_l), batch_size_l, "labeled stream")
        _check_full_batch(len(x_u), batch_size, "unlabeled stream")
    avg = Averager(mesh)
    labeled_iter = batch_indices(len(x_l), batch_size_l, shuffle_rng, drop)
    for idx_u in batch_indices(len(x_u), batch_size, shuffle_rng, drop):
        try:
            idx_l = next(labeled_iter)
        except StopIteration:
            labeled_iter = batch_indices(len(x_l), batch_size_l, shuffle_rng,
                                         drop)
            idx_l = next(labeled_iter)
        if drop:
            idx_u, idx_l = _rank_slice(idx_u, mesh), _rank_slice(idx_l, mesh)
        idx_u = torch.as_tensor(idx_u, device=x_u.device)
        idx_l = torch.as_tensor(idx_l, device=x_l.device)
        avg.add(step(x_u[idx_u], x_l[idx_l], y_l[idx_l], generator=generator))
    return avg.result()


def _drive(run: Callable, data: tuple, *, seed: int, epochs: int,
           start_epoch: int, on_epoch: Callable | None,
           post_epoch: Callable | None,
           post_epoch_pred: Callable | None, mesh=None) -> list[dict]:
    """Epochs ``start_epoch .. epochs - 1`` of ``run(*data, generator)``,
    each with the generator derived from ``(seed, epoch)`` and, at world
    size > 1, the rank."""
    history = []
    for epoch in range(start_epoch, epochs):
        metrics = run(*data, derived_generator(seed, EPOCH, epoch,
                                               *rank_path(mesh),
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
               post_update: Callable | None = None,
               mesh=None, graph_noise: Callable | None = None
               ) -> list[dict]:
    """Train epochs ``start_epoch .. epochs - 1``. ``on_epoch(epoch,
    metrics)`` gets host floats after each; ``post_epoch(epoch)`` runs
    after it on the epochs where ``post_epoch_pred(epoch)`` is true (every
    epoch without a predicate), when the model and optimizer that ``step``
    updates in place hold the exact post-epoch state; ``post_update()``
    runs after every step, the counterpart of the JAX trainers'
    ``post_update`` (the TVAE's sigma clamp). A dataset smaller than
    ``batch_size`` trains one full-dataset step per epoch. Returns the
    per-epoch metric dicts. The InfoMax step updates its model and
    discriminator in place, so it runs here as any step does. Under a
    ``mesh`` this rank trains on its shard of ``x, y`` (module docstring)
    and ``step`` must average its gradients over the same mesh.
    ``graph_noise`` (one device, CUDA tensors) replays each step from a
    CUDA graph (``train/scanned.py::make_epoch_runner``), captured once
    for the call."""
    if mesh is not None:
        x, y = shard_rows(mesh, x, y)
        # both are multiples of the world size, so the clamp divides
        local = split_batch(min(batch_size, len(x) * mesh.size), mesh)
    else:
        local = min(batch_size, len(x))
    run = make_epoch_runner(step, batch_size=local, post_update=post_update,
                            mesh=mesh, graph_noise=graph_noise)
    return _drive(run, (x, y), seed=seed, epochs=epochs,
                  start_epoch=start_epoch, on_epoch=on_epoch,
                  post_epoch=post_epoch, post_epoch_pred=post_epoch_pred,
                  mesh=mesh)


def run_epochs_semi(step: Callable, x_u, x_l, y_l, *, seed: int,
                    epochs: int, batch_size: int, batch_size_l: int,
                    start_epoch: int = 0,
                    on_epoch: Callable | None = None,
                    mesh=None, graph_noise: Callable | None = None
                    ) -> list[dict]:
    """:func:`run_epochs` for the two-stream semi-supervised runner
    (``train/scanned.py::make_scanned_epochs_semi``), each batch size
    clamped to its stream; under a ``mesh`` both streams are sharded.
    ``graph_noise`` (one device, CUDA tensors) replays each step from a
    CUDA graph, captured once for the call."""
    if mesh is not None:
        x_u, x_l, y_l = shard_rows(mesh, x_u, x_l, y_l)
        bs = split_batch(min(batch_size, len(x_u) * mesh.size), mesh)
        bs_l = split_batch(min(batch_size_l, len(x_l) * mesh.size), mesh,
                           name="batch_sizeL")
    else:
        bs, bs_l = min(batch_size, len(x_u)), min(batch_size_l, len(x_l))
    run = make_scanned_epochs_semi(step, bs, bs_l, mesh, graph_noise)
    return _drive(run, (x_u, x_l, y_l), seed=seed, epochs=epochs,
                  start_epoch=start_epoch, on_epoch=on_epoch,
                  post_epoch=None, post_epoch_pred=None, mesh=mesh)
