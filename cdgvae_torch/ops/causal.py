"""Causal latent layer: linear SEM solve + per-node flows.

Port of ``cdgvae_tpu/ops/causal.py:36-151``:

    z_orig = eps @ (I - B)^{-1}          (linear SEM, solved in closed form)
    z      = f(z_orig)                    (per-node invertible 1-D flow)

and the do-operator:

    z_struct = flow^{-1}(z) with z[do] := value
    for j != do (topological order): z_struct[:, j] = z_struct[:, :j] @ B[:j, j] + eps[:, j]
    z_do = flow(z_struct)

``(I - B)^{-1}`` is computed once on the host in float64 and cast. The
solve must run in full float32: callers keep
``torch.backends.cuda.matmul.allow_tf32`` False (the entry points set it).
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
        # ancestral_propagate needs the nodes in topological order (B
        # strictly upper-triangular); checked when it runs, so that other
        # DAGs still build
        self.topo_ordered = bool(np.allclose(np.tril(B), 0.0))
        self.node = B.shape[0]
        self.register_buffer("B", torch.as_tensor(B, dtype=torch.float32,
                                                  device=device),
                             persistent=False)
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

    def ancestral_propagate(self, z_struct: torch.Tensor, eps: torch.Tensor,
                            do_index: int) -> torch.Tensor:
        """Re-propagate the exogenous noise ``eps`` through the SEM, holding
        column ``do_index`` of the structural values ``z_struct`` [batch,
        node] fixed."""
        if not self.topo_ordered:
            raise ValueError(
                "ancestral_propagate requires a topologically ordered "
                "(strictly upper-triangular) B: column j may only depend on "
                "columns < j. Reorder the nodes; a valid-but-unordered DAG "
                "would silently drop its below-diagonal edges here.")
        cols = list(z_struct.unbind(1))
        for j in range(self.node):
            if j == do_index:
                continue
            if j == 0:
                cols[j] = eps[:, 0]
            else:
                parents = torch.stack(cols[:j], dim=1)
                cols[j] = parents @ self.B[:j, j].to(parents.dtype) \
                    + eps[:, j]
        return torch.stack(cols, dim=1)

    def do_intervention(self, latent: torch.Tensor, eps: torch.Tensor,
                        do_index: int, value) -> torch.Tensor:
        """do(z_{do_index} := value): inverse flow, ancestral
        re-propagation, flow. ``do_index`` is a Python int; ``value`` a
        scalar or a [batch] tensor. Returns the intervened latent [batch,
        node]."""
        value = torch.as_tensor(value, dtype=latent.dtype,
                                device=latent.device)
        latent_do = latent.clone()
        latent_do[:, do_index] = value.expand(latent.shape[0])
        z_struct = self.inverse(latent_do)
        z_struct = self.ancestral_propagate(z_struct, eps, do_index)
        z_do, _ = self.flows(z_struct)
        return z_do
