"""Train steps for the tabular family (port of ``cdgvae_tpu/train/
tabular_steps.py``).

The losses are the pendulum family's (``train/scanned.py::
make_supervised_loss_fn``, ``train/steps.py::make_infomax_loss_fn``) with
the dataset's reconstruction term:

* loan: ``0.5 * sum((xhat - x[:, flatten_topology])^2)``, batch mean;
* adult: that on the non-income columns plus BCE-with-logits on income;
* covtype: that on the 7 continuous columns plus the NLL of the 7-way
  Cover_Type head (the labels are 1-based).

The alignment reads every label column (a tabular label has one column a
node). On one device InfoMax's marginal is a permutation of the batch,
as the JAX CLI's single-device paths build it; under a mesh the CLI
passes ``marginal="roll"`` (``cdgvae_tpu/cli/tabular_main.py:133-135``).
Every step builder takes a ``mesh`` that averages its gradients.

The CDG-TVAE's reconstruction walks the DataTransformer's output spans:
a Gaussian NLL with the learned ``sigma`` for each tanh column and a
cross-entropy for each softmax span, KL weight 1. The reference loops
over the spans; here all tanh columns are one gather and all softmax
spans one ``log_softmax`` over a [batch, spans, widest] gather padded
with -inf, the indices kept per device, so that a step is a handful of
kernels and copies nothing from the host. The sigma clamp after every
update is :func:`make_sigma_clamp`, which the epoch drivers run as their
``post_update``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import losses
from .scanned import make_supervised_loss_fn
from .steps import (_metrics, make_infomax_loss_fn, pair_infomax_optimizer,
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
                      lam: float, recon_fn: Callable, mesh=None) -> Callable:
    """Supervised tabular VAE/CDG-VAE step ``step(x, y, noise=None,
    generator=None) -> metrics``."""
    return step_from_loss(make_tabular_loss_fn(model, beta, lam, recon_fn),
                          optimizer, mesh)


def make_tabular_infomax_loss_fn(model, discriminator, beta: float,
                                 lam: float, gamma: float,
                                 recon_fn: Callable,
                                 marginal: str = "permutation") -> Callable:
    """Tabular InfoMax loss ``loss_fn(x, y, noise=None, perm=None,
    shift=None, generator=None) -> (ref_loss + MI, metrics)``: the
    (γ+1)·MI gradient reaches the model and the discriminator.
    ``marginal`` is :func:`steps.marginal_epsilon`'s mode."""
    return make_infomax_loss_fn(model, discriminator, beta, lam, gamma,
                                marginal=marginal, recon_fn=recon_fn)


def make_tabular_infomax_step(model, discriminator,
                              optimizer: torch.optim.Optimizer,
                              optimizer_d: torch.optim.Optimizer,
                              beta: float, lam: float, gamma: float,
                              recon_fn: Callable,
                              marginal: str = "permutation",
                              mesh=None) -> Callable:
    """Tabular InfoMax step: updates the model and the discriminator in
    place, each with its own Adam (under a ``mesh`` both gradients are
    averaged in one buffer)."""
    return step_from_loss(
        make_tabular_infomax_loss_fn(model, discriminator, beta, lam, gamma,
                                     recon_fn, marginal),
        pair_infomax_optimizer(optimizer, optimizer_d), mesh)


def flatten_spans(output_info_list) -> tuple:
    """DataTransformer spans -> a tuple of (start, dim, is_softmax)."""
    spans, start = [], 0
    for column_info in output_info_list:
        for span in column_info:
            spans.append((start, span.dim, span.activation_fn == "softmax"))
            start += span.dim
    return tuple(spans)


def _span_indices(spans) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(the tanh columns [T]; the softmax spans' columns [S, widest],
    padded with column 0; the padding [S, widest] bool)."""
    tanh = np.array([s for s, _, soft in spans if not soft], np.int64)
    soft = [(s, d) for s, d, is_soft in spans if is_soft]
    width = max((d for _, d in soft), default=0)
    gather = np.zeros((len(soft), width), np.int64)
    pad = np.ones((len(soft), width), bool)
    for i, (s, d) in enumerate(soft):
        gather[i, :d] = np.arange(s, s + d)
        pad[i, :d] = False
    return tanh, gather, pad


def make_tvae_loss_fn(model, lam: float, output_info_list) -> Callable:
    """CDG-TVAE loss ``loss_fn(x, y, noise=None, generator=None) -> (loss,
    metrics)``: the span-walking reconstruction (see the module
    docstring), KL weight 1, ``lam`` times the alignment."""
    node = model.node
    arrays = _span_indices(flatten_spans(output_info_list))
    per_device = {}

    def indices(device):
        if device not in per_device:
            per_device[device] = [torch.as_tensor(a, device=device)
                                  for a in arrays]
        return per_device[device]

    def loss_fn(x, y, noise=None, generator=None):
        out = model(x, noise=noise, generator=generator)
        tanh, gather, pad = indices(x.device)
        std = model.sigma[tanh]
        residual = x[:, tanh] - torch.tanh(out.xhat[:, tanh])
        recon = (residual ** 2 / 2.0 / std ** 2).mean(0).sum() \
            + torch.log(std).sum()
        logp = F.log_softmax(out.xhat[:, gather].masked_fill(
            pad, -torch.inf), dim=2)
        labels = x[:, gather].masked_fill(pad, -torch.inf).argmax(2)
        recon = recon - logp.gather(2, labels[..., None]).mean(0).sum()
        kl = losses.kl_std_normal(out.mean, out.logvar)
        align = losses.alignment_bce(out.align_latent, y[:, :node])
        loss = recon + kl + lam * align
        return loss, _metrics(loss, recon, kl, align, out.logvar, node)

    return loss_fn


def make_sigma_clamp(model, sigma_range=(0.01, 0.1)) -> Callable:
    """``post_update()``: clamp the TVAE's ``sigma`` into ``sigma_range``
    in place, as the reference does after every optimizer step."""
    low, high = sigma_range

    @torch.no_grad()
    def post_update():
        model.sigma.clamp_(low, high)

    return post_update


def make_tvae_step(model, optimizer: torch.optim.Optimizer, lam: float,
                   output_info_list, mesh=None) -> Callable:
    """CDG-TVAE step ``step(x, y, noise=None, generator=None) -> metrics``;
    the drivers follow each with :func:`make_sigma_clamp`'s hook."""
    return step_from_loss(make_tvae_loss_fn(model, lam, output_info_list),
                          optimizer, mesh)
