"""Auxiliary models: the InfoMax discriminator and the masked factor
classifier, the CDM metric's probe (port of ``cdgvae_tpu/models/
classifier.py:17-61``).

Parameter names match the JAX pytrees (``net.layer0.w``,
``classify.layer0.w`` ...), so a JAX param tree loads by copy
(``utils/interop.py``). The classifier runs its ``node`` MLPs as one
stacked product over a leading node axis.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn import MLP, StackedMLP


class Discriminator(nn.Module):
    """InfoMax MI discriminator: an MLP on ``cat(flatten(x), eps)``,
    12288 + node -> hidden -> hidden -> 1 at 64 px."""

    def __init__(self, node: int, image_size: int = 64, hidden: int = 300, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.in_dim = 3 * image_size * image_size + node
        self.net = MLP([self.in_dim, hidden, hidden, 1], generator=generator,
                       device=device)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """x [batch, H, W, 3], z [batch, node] -> [batch, 1]."""
        return self.net(torch.cat([x.reshape(x.shape[0], -1), z], dim=1))


class FactorClassifier(nn.Module):
    """Per-node MLP on the masked image ``x * m_j`` -> logit; ``masks`` is
    [node, H, W, 3]."""

    def __init__(self, masks, node: int, image_size: int = 64,
                 hidden: int = 300, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        masks = np.asarray(masks, dtype=np.float32)
        if masks.shape[0] != node:
            raise ValueError(f"{masks.shape[0]} masks for {node} nodes")
        self.node = node
        self.image_size = image_size
        self.register_buffer("masks", torch.as_tensor(masks, device=device),
                             persistent=False)
        self.classify = StackedMLP(node, [3 * image_size * image_size,
                                          hidden, hidden, 1],
                                   generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [batch, H, W, 3] -> logits [batch, node]."""
        masked = x[None] * self.masks[:, None]            # [node,batch,H,W,3]
        out = self.classify(masked.reshape(self.node, x.shape[0], -1))
        return out[..., 0].T
