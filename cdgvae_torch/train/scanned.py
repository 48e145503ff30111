"""The supervised loss and the epoch runners (port of
``cdgvae_tpu/train/scanned.py:75-199,219-247``).

The epoch runners keep the semantics of ``make_scanned_epochs`` and
``make_scanned_epochs_semi``: one
permutation of the flat ``[n, 3·H·W]`` dataset per epoch from the epoch's
``torch.Generator`` (``train/loop.py::run_epochs`` derives it from the
seed and the epoch), the last partial batch dropped, metrics accumulated
on the device and averaged per epoch with one host sync per epoch. Steps
run as a plain Python loop.

Under a mesh (``parallel.mesh.Mesh``) the same runners are the sharded
trainers of ``cdgvae_tpu/train/scanned.py:276-466``: each rank runs them
on its own shard of the rows, with its own generator, at the local batch
size, the step averages the gradients, and the epoch metrics are the
cross-rank mean, reduced once an epoch (the mean is linear, so this equals
the reference's per-step ``pmean`` of the metrics).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops import losses
from ..parallel.mesh import all_reduce_mean
from .steps import _metrics


class Averager:
    """Accumulates dicts of device tensors, each a step's scalar or a run's
    [steps] stack; ``result()`` is the mean over every step added, in one
    host sync, its keys sorted as JAX's pytree flattening orders them (and
    so the JAX trainers' console lines and logs). Under a ``mesh`` the
    result is the mean over its ranks too, one ``all_reduce``."""

    def __init__(self, mesh=None):
        self._acc = []
        self._mesh = mesh

    def add(self, metrics: dict):
        self._acc.append(metrics)

    def result(self) -> dict:
        if not self._acc:
            return {}
        keys = sorted(self._acc[0])
        means = torch.stack([torch.cat([m[k].reshape(-1)
                                        for m in self._acc]).mean()
                             for k in keys])
        if self._mesh is not None:
            all_reduce_mean([means], self._mesh)
        return dict(zip(keys, means.tolist()))


def make_supervised_loss_fn(model, beta: float, lam: float,
                            free_bits: float = 0.0,
                            recon_fn: Callable = losses.gaussian_recon
                            ) -> Callable:
    """ELBO + alignment loss as ``loss_fn(x, y, noise=None,
    generator=None) -> (loss, metrics)``; ``recon_fn(xhat, x)`` is the
    reconstruction term (the tabular family's is per dataset)."""
    node = model.node

    def loss_fn(x, y, noise=None, generator=None):
        out = model(x, noise=noise, generator=generator, fast=True)
        recon = recon_fn(out.xhat, x)
        if free_bits > 0.0:
            kl = losses.kl_std_normal_free_bits(out.mean, out.logvar,
                                                free_bits)
        else:
            kl = losses.kl_std_normal(out.mean, out.logvar)
        align = losses.alignment_bce(out.align_latent, y[:, :node])
        loss = recon + beta * kl + lam * align
        return loss, _metrics(loss, recon, kl, align, out.logvar, node)

    return loss_fn


def epoch_batches(n: int, batch_size: int,
                  generator: torch.Generator) -> torch.Tensor:
    """One epoch's shuffled indices as [n // batch_size, batch_size]; the
    remainder is dropped."""
    steps = n // batch_size
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm[: steps * batch_size].reshape(steps, batch_size)


def make_epoch_runner(step_fn: Callable, batch_size: int,
                      post_update: Callable | None = None,
                      mesh=None) -> Callable:
    """Wrap a ``step(x, y, generator=...) -> metrics`` into an epoch runner,
    the counterpart of ``make_scanned_epochs``.

    Returns run(x, y, generator) -> the epoch's mean metrics as host
    floats, keys sorted. ``x`` is [n, ...] items, ``y`` [n, .]; both on
    the generator's device, which draws the permutation and then each
    step's noise. ``post_update()`` runs after every step (the TVAE's
    sigma clamp, the CelebA ``sn_refresh``). Under a ``mesh`` each rank
    runs it on its shard at its local ``batch_size`` (module docstring).
    """

    def run(x, y, generator: torch.Generator) -> dict:
        n = x.shape[0]
        steps = n // batch_size
        if steps == 0:
            raise ValueError(
                f"dataset ({n}) smaller than batch_size ({batch_size}); "
                "clamp the batch size (train.loop.run_epochs does)")
        xf, item_shape = x.reshape(n, -1), x.shape[1:]
        avg = Averager(mesh)
        for idx in epoch_batches(n, batch_size, generator):
            xi = xf[idx].reshape(batch_size, *item_shape)
            avg.add(step_fn(xi, y[idx], generator=generator))
            if post_update is not None:
                post_update()
        return avg.result()  # the one host sync

    return run


def labeled_batches(n_l: int, steps: int, batch_size_l: int,
                    generator: torch.Generator) -> torch.Tensor:
    """An epoch's labeled indices as [steps, batch_size_l]: ``ceil(steps ·
    batch_size_l / n_l)`` permutations of ``n_l`` concatenated and cut, so
    every batch is full and the stream reshuffles when it runs out."""
    need = steps * batch_size_l
    perms = [torch.randperm(n_l, generator=generator, device=generator.device)
             for _ in range(-(-need // n_l))]
    return torch.cat(perms)[:need].reshape(steps, batch_size_l)


def make_scanned_epochs_semi(step_fn: Callable, batch_size: int,
                             batch_size_l: int, mesh=None) -> Callable:
    """Semi-supervised epoch runner, the counterpart of
    ``make_scanned_epochs_semi``: the unlabeled stream drives the epoch and
    drops its remainder; the labeled stream cycles through
    :func:`labeled_batches`, so every labeled batch is exactly
    ``batch_size_l``. The epoch's generator draws the unlabeled
    permutation, then the labeled ones, then each step's noise.

    ``step_fn(x_u, x_l, y_l, generator=...) -> metrics``. Returns
    run(x_u, x_l, y_l, generator) -> the epoch's mean metrics as host
    floats, keys sorted. Use ``train.loop.train_epoch_semi`` (``--eager``)
    for the reference's protocol with short batches. Under a ``mesh``
    each rank cycles its own labeled shard (module docstring).
    """

    def run(x_u, x_l, y_l, generator: torch.Generator) -> dict:
        n_u, n_l = x_u.shape[0], x_l.shape[0]
        steps = n_u // batch_size
        if steps == 0 or n_l < batch_size_l:
            raise ValueError(
                f"streams too small (unlabeled {n_u} vs batch {batch_size}; "
                f"labeled {n_l} vs batch {batch_size_l}); clamp the batch "
                "sizes or use the eager train_epoch_semi")
        xf_u, xf_l = x_u.reshape(n_u, -1), x_l.reshape(n_l, -1)
        idx_u = epoch_batches(n_u, batch_size, generator)
        idx_l = labeled_batches(n_l, steps, batch_size_l, generator)
        avg = Averager(mesh)
        for iu, il in zip(idx_u, idx_l):
            avg.add(step_fn(xf_u[iu].reshape(batch_size, *x_u.shape[1:]),
                            xf_l[il].reshape(batch_size_l, *x_l.shape[1:]),
                            y_l[il], generator=generator))
        return avg.result()  # the one host sync

    return run
