"""Per-node invertible 1-D flows, vectorised across the causal-node axis.

Port of ``cdgvae_tpu/ops/flows.py:36-153``. Per-node parameters are stacked
along a leading ``node`` axis, so the forward/inverse/logdet of all nodes is
a few elementwise ops on ``[batch, node]`` tensors.

* ``affine`` (linear SCM): ``z = p0 * eps + p1``, logdet ``log|p0|``.
* ``planar`` (nonlinear SCM): scalar planar flows with ELU, the
  invertibility construction ``_build_u`` and the Picard fixed-point
  inverse with ``inverse_loop`` iterations per layer.

Parameter names follow the JAX pytree: ``p`` [node, 2] for affine and
``w``/``b``/``u`` [node, flow_num] for planar.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import uniform_param


# ---------------------------------------------------------------------------
# Affine flow (linear SCM)
# ---------------------------------------------------------------------------

def affine_forward(p: torch.Tensor, eps: torch.Tensor):
    z = p[:, 0] * eps + p[:, 1]
    logdet = torch.log(torch.abs(p[:, 0])).expand(eps.shape)
    return z, logdet


def affine_inverse(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (z - p[:, 1]) / p[:, 0]


# ---------------------------------------------------------------------------
# Planar flow (nonlinear SCM), scalar (input_dim=1) specialisation
# ---------------------------------------------------------------------------

def _build_u(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Scalar case of u_hat = u + (softplus(w·u) - 1 - w·u) * w / ||w||^2."""
    wu = w * u
    term1 = -1.0 + F.softplus(wu)
    return u + (term1 - wu) * (w / (w * w))


def planar_forward(w: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
                   eps: torch.Tensor, alpha: float = 1.0):
    """[batch, node] -> ([batch, node], [batch, node] logdet).

    Per flow layer j: h <- h + u_hat_j * elu(h * w_j + b_j),
    logdet += log|1 + elu'(pre) * w_j * u_hat_j|.
    """
    h = eps
    logdet = torch.zeros_like(eps)
    for j in range(w.shape[1]):
        wj, bj = w[:, j], b[:, j]
        u_hat = _build_u(u[:, j], wj)
        pre = h * wj + bj
        grad = torch.where(pre > 0, 1.0, alpha * torch.exp(pre))
        logdet = logdet + torch.log(torch.abs(1.0 + grad * wj * u_hat))
        h = h + u_hat * F.elu(pre, alpha)
    return h, logdet


def planar_inverse(w: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
                   z: torch.Tensor, inverse_loop: int = 100,
                   alpha: float = 1.0) -> torch.Tensor:
    """Picard fixed-point inverse, ``inverse_loop`` iterations per layer."""
    h = z
    for j in reversed(range(w.shape[1])):
        wj, bj = w[:, j], b[:, j]
        u_hat = _build_u(u[:, j], wj)
        zk = h
        for _ in range(inverse_loop):
            zk = h - u_hat * F.elu(zk * wj + bj, alpha)
        h = zk
    return h


# ---------------------------------------------------------------------------
# Module choosing the flow family per the ``scm`` config string
# ---------------------------------------------------------------------------

class SCMFlows(nn.Module):
    """``scm='linear'`` -> affine, ``scm='nonlinear'`` -> planar.

    Init: affine ``p ~ U(0, 0.1)``; planar ``w, b, u ~ N(0, 0.1^2)``, the
    JAX package's distributions, drawn from ``generator`` on the host.
    """

    def __init__(self, scm: str, node: int, flow_num: int = 1,
                 inverse_loop: int = 100, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if scm not in ("linear", "nonlinear"):
            raise ValueError("Not supported SCM!")
        self.scm = scm
        self.inverse_loop = inverse_loop
        if scm == "linear":
            self.p = uniform_param((node, 2), 0.0, 0.1, generator, device)
        else:
            for name in ("w", "b", "u"):
                t = torch.randn((node, flow_num), generator=generator) * 0.1
                setattr(self, name, nn.Parameter(t.to(device)))

    def forward(self, eps: torch.Tensor):
        if self.scm == "linear":
            return affine_forward(self.p, eps)
        return planar_forward(self.w, self.b, self.u, eps)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        if self.scm == "linear":
            return affine_inverse(self.p, z)
        return planar_inverse(self.w, self.b, self.u, z, self.inverse_loop)
