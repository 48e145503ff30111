"""Causal latent layer: linear SEM solve + per-node flows.

Port of ``cdgvae_tpu/ops/causal.py:36-108``:

    z_orig = eps @ (I - B)^{-1}          (linear SEM, solved in closed form)
    z      = f(z_orig)                    (per-node invertible 1-D flow)

``(I - B)^{-1}`` is computed once on the host in float64 and cast. The
solve must run in full float32: callers keep
``torch.backends.cuda.matmul.allow_tf32`` False (the entry points set it).
The do-operator (``ancestral_propagate``, ``do_intervention``) belongs to
the eval slice and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .flows import SCMFlows


def scale_adjacency(B: np.ndarray) -> np.ndarray:
    """In-degree column scaling."""
    B = np.asarray(B, dtype=np.float64).copy()
    indegree = B.sum(axis=0)
    mask = indegree != 0
    B[:, mask] = B[:, mask] / indegree[mask]
    return B


def is_dag(W: np.ndarray) -> bool:
    """W is a DAG iff its binarised adjacency is nilpotent."""
    A = (np.abs(np.asarray(W, dtype=np.float64)) > 0).astype(np.float64)
    M = A.copy()
    for _ in range(A.shape[0]):
        if not M.any():
            return True
        M = M @ A
    return not M.any()


class CausalGraph(nn.Module):
    """The SEM solve ``(I - B)^{-1}`` of a fixed adjacency ``B`` and the
    flow params (``flows.p`` or ``flows.w/b/u``)."""

    def __init__(self, B: np.ndarray, scm: str = "linear", flow_num: int = 1,
                 inverse_loop: int = 100, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        B = np.asarray(B, dtype=np.float64)
        if not is_dag(B):
            raise ValueError("B must be a DAG")
        self.node = B.shape[0]
        self.register_buffer(
            "I_B_inv", torch.as_tensor(np.linalg.inv(np.eye(self.node) - B),
                                       dtype=torch.float32, device=device),
            persistent=False)
        self.flows = SCMFlows(scm, self.node, flow_num, inverse_loop,
                              generator=generator, device=device)

    def transform(self, eps: torch.Tensor):
        """eps [batch, node] -> (orig_latent, latent, logdet), each
        [batch, node]."""
        orig_latent = eps @ self.I_B_inv.to(eps.dtype)
        latent, logdet = self.flows(orig_latent)
        return orig_latent, latent, logdet

    def inverse(self, latent: torch.Tensor) -> torch.Tensor:
        """latent [batch, node] -> pre-flow structural values."""
        return self.flows.inverse(latent)
