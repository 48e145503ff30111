"""Train steps for the tabular family (port of ``cdgvae_tpu/train/
tabular_steps.py:25-142``).

The losses are the pendulum family's (``train/scanned.py::
make_supervised_loss_fn``, ``train/steps.py::make_infomax_loss_fn``) with
the dataset's reconstruction term:

* loan: ``0.5 * sum((xhat - x[:, flatten_topology])^2)``, batch mean;
* adult: that on the non-income columns plus BCE-with-logits on income;
* covtype: that on the 7 continuous columns plus the NLL of the 7-way
  Cover_Type head (the labels are 1-based).

The alignment reads every label column (a tabular label has one column a
node). On one device InfoMax's marginal is a permutation of the batch,
as the JAX CLI's single-device paths build it.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ..ops import losses
from .scanned import make_supervised_loss_fn
from .steps import (make_infomax_loss_fn, pair_infomax_optimizer,
                    step_from_loss)


def make_recon_fn(dataset: str, flatten_topology: Sequence[int]) -> Callable:
    """``recon_fn(xhat, x) -> scalar`` of ``dataset``; ``xhat`` is in
    topology order, ``x`` in the dataset's column order. The column order
    is kept as an index tensor per device, so that a step copies nothing
    from the host."""
    flat, index = list(flatten_topology), {}

    def topology_order(x):
        if x.device not in index:
            index[x.device] = torch.tensor(flat, device=x.device)
        return x.index_select(1, index[x.device])

    def sq(d):
        return 0.5 * (d * d).sum(dim=1).mean()

    if dataset == "loan":
        def recon_fn(xhat, x):
            return sq(xhat - topology_order(x))
    elif dataset == "adult":
        def recon_fn(xhat, x):
            x_ = topology_order(x)
            r = sq(xhat[:, :2] - x_[:, :2])
            r = r + sq(xhat[:, 3:] - x_[:, 3:])
            return r + losses.stable_bce(xhat[:, 2], x_[:, 2]).mean()
    elif dataset == "covtype":
        def recon_fn(xhat, x):
            r = sq(xhat[:, :7] - x[:, :7])
            logp = F.log_softmax(xhat[:, 7:], dim=1)
            labels = (x[:, 7] - 1.0).to(torch.int64)
            return r - logp.gather(1, labels[:, None]).mean()
    else:
        raise ValueError("Not supported dataset!")
    return recon_fn


def make_tabular_loss_fn(model, beta: float, lam: float,
                         recon_fn: Callable) -> Callable:
    """Supervised tabular loss ``loss_fn(x, y, noise=None, generator=None)
    -> (loss, metrics)``."""
    return make_supervised_loss_fn(model, beta, lam, recon_fn=recon_fn)


def make_tabular_step(model, optimizer: torch.optim.Optimizer, beta: float,
                      lam: float, recon_fn: Callable) -> Callable:
    """Supervised tabular VAE/CDG-VAE step ``step(x, y, noise=None,
    generator=None) -> metrics``."""
    return step_from_loss(make_tabular_loss_fn(model, beta, lam, recon_fn),
                          optimizer)


def make_tabular_infomax_loss_fn(model, discriminator, beta: float,
                                 lam: float, gamma: float,
                                 recon_fn: Callable) -> Callable:
    """Tabular InfoMax loss ``loss_fn(x, y, noise=None, perm=None,
    shift=None, generator=None) -> (ref_loss + MI, metrics)``: the
    (γ+1)·MI gradient reaches the model and the discriminator."""
    return make_infomax_loss_fn(model, discriminator, beta, lam, gamma,
                                recon_fn=recon_fn)


def make_tabular_infomax_step(model, discriminator,
                              optimizer: torch.optim.Optimizer,
                              optimizer_d: torch.optim.Optimizer,
                              beta: float, lam: float, gamma: float,
                              recon_fn: Callable) -> Callable:
    """Tabular InfoMax step: updates the model and the discriminator in
    place, each with its own Adam."""
    return step_from_loss(
        make_tabular_infomax_loss_fn(model, discriminator, beta, lam, gamma,
                                     recon_fn),
        pair_infomax_optimizer(optimizer, optimizer_d))
