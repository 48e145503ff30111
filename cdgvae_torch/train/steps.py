"""Supervised train step for the pendulum family (port of
``cdgvae_tpu/train/steps.py:28-98``).

The step runs forward, loss, backward and the Adam update in place on the
model and optimizer it closes over. Metrics come back as device scalars
keyed exactly like the reference's log dict (``loss, recon, KL, alignment,
posterior_variance1..node``); the epoch runner accumulates them on the
device and syncs once per epoch.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops import losses


def _metrics(loss, recon, kl, align, logvar, node) -> dict:
    m = {"loss": loss, "recon": recon, "KL": kl, "alignment": align}
    pv = losses.posterior_variance(logvar)
    for i in range(node):
        m[f"posterior_variance{i + 1}"] = pv[i]
    return m


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults, whose update is algebraically the
    same: b1 0.9, b2 0.999, eps 1e-8 added outside the square root."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def make_train_step(model, optimizer: torch.optim.Optimizer, beta: float,
                    lam: float, free_bits: float = 0.0) -> Callable:
    """Supervised VAE/CDG-VAE step.

    Returns step(x, y, noise=None, generator=None) -> metrics dict of
    detached device scalars. ``free_bits > 0`` floors the per-dim KL.
    """
    from .scanned import make_supervised_loss_fn

    loss_fn = make_supervised_loss_fn(model, beta, lam, free_bits=free_bits)

    def step(x, y, noise=None, generator=None):
        loss, metrics = loss_fn(x, y, noise=noise, generator=generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
