"""Loss terms of the pendulum, tabular and CelebA families, as plain
functions on tensors.

Port of ``cdgvae_tpu/ops/losses.py``, with the same reductions (sum over
feature axes, mean over batch):

* ``gaussian_recon``    0.5 * sum((xhat-x)^2) per sample, batch mean
* ``l1_recon``          sum(|xhat-x|) per sample, batch mean (CelebA)
* ``kl_std_normal``     analytic KL( N(mean, diag e^logvar) || N(0, I) )
* ``kl_std_normal_free_bits``  per-dim batch-mean KL floored at free_bits
* ``alignment_bce``     per-node BCE-with-logits summed over nodes, batch
                        mean, in the stable logits form (not sigmoid + BCE)
* ``clipped_bce_probs`` elementwise BCE in probability space, clipped to
                        [eps, 1 - eps] (torch ``BCELoss`` on sigmoid
                        outputs; deliberately not ``stable_bce``)
* ``infomax_mi``        the negative f-divergence MI bound of InfoMax
* ``posterior_variance`` per-node mean posterior variance
"""
from __future__ import annotations

import torch


def gaussian_recon(xhat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    d = (xhat - x).float()
    return 0.5 * (d * d).sum(dim=tuple(range(1, d.ndim))).mean()


def l1_recon(xhat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    d = (xhat - x).abs().float()
    return d.sum(dim=tuple(range(1, d.ndim))).mean()


def kl_std_normal(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    mean, logvar = mean.float(), logvar.float()
    kl = (mean ** 2 - logvar + torch.exp(logvar) - 1.0).sum(dim=1)
    return 0.5 * kl.mean()


def kl_std_normal_free_bits(mean: torch.Tensor, logvar: torch.Tensor,
                            free_bits: float) -> torch.Tensor:
    mean, logvar = mean.float(), logvar.float()
    kl_dim = 0.5 * (mean ** 2 - logvar + torch.exp(logvar) - 1.0).mean(dim=0)
    return torch.clamp(kl_dim, min=free_bits).sum()


def stable_bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise ``max(z,0) - z*y + log(1+exp(-|z|))``."""
    return torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))


def alignment_bce(align_latent: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    z = align_latent.float()
    return stable_bce(z, labels.to(z.dtype)).sum(dim=1).mean()


def clipped_bce_probs(p: torch.Tensor, y: torch.Tensor,
                      eps: float = 1e-7) -> torch.Tensor:
    """Elementwise ``-(y log p + (1 - y) log(1 - p))`` with ``p`` clipped
    to [eps, 1 - eps]; its gradient saturates under the clip."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(y * torch.log(p) + (1 - y) * torch.log(1 - p))


def infomax_mi(d_joint: torch.Tensor, d_marginal: torch.Tensor
               ) -> torch.Tensor:
    """MI = -(E[D(x, eps)] - E[exp(D(x, eps_marginal) - 1)])."""
    return -(d_joint.mean() - torch.exp(d_marginal - 1.0).mean())


def posterior_variance(logvar: torch.Tensor) -> torch.Tensor:
    """Returns [node]."""
    return torch.exp(logvar).mean(dim=0)
