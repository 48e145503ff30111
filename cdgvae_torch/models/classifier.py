"""Auxiliary models: the InfoMax discriminator, the masked factor
classifier (the CDM metric's probe) and the downstream classifier (port of
``cdgvae_tpu/models/classifier.py:17-77``).

Parameter names match the JAX pytrees (``net.layer0.w``,
``classify.layer0.w`` ...), so a JAX param tree loads by copy
(``utils/interop.py``). The factor classifier runs its ``node`` MLPs as
one stacked product over a leading node axis; the downstream classifier
holds ``members`` independent copies the same way, so that the repeats of
a downstream eval train as one.
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


class DownstreamClassifier(nn.Module):
    """``members`` independent in_dim -> 2 -> 1 MLPs (ELU hidden layer,
    sigmoid output) on latent means, as one stacked product: params
    ``classify.layer{0,1}.w`` [members, in, out] and ``.b`` [members, 1,
    out]. Member m is the JAX ``DownstreamClassifier``'s tree
    ``classify.layer{0,1}.{w [in, out], b [out]}`` (:meth:`load_trees`,
    :meth:`trees`)."""

    def __init__(self, in_dim: int, members: int = 1, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.members = members
        self.classify = StackedMLP(members, [in_dim, 2, 1],
                                   generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [members, batch, in] (or [batch, in], the same rows for every
        member) -> probabilities [members, batch, 1]."""
        if x.ndim == 2:
            x = x.expand(self.members, *x.shape)
        return torch.sigmoid(self.classify(x))

    def load_trees(self, trees) -> None:
        """Copy one JAX param tree into each member."""
        if len(trees) != self.members:
            raise ValueError(f"{len(trees)} trees for {self.members} members")
        with torch.no_grad():
            for i in range(2):
                layer = getattr(self.classify, f"layer{i}")
                for m, tree in enumerate(trees):
                    p = tree["classify"][f"layer{i}"]
                    layer.w[m].copy_(torch.as_tensor(np.array(
                        p["w"], np.float32)).reshape(layer.w.shape[1:]))
                    layer.b[m, 0].copy_(torch.as_tensor(np.array(
                        p["b"], np.float32)).reshape(layer.b.shape[2:]))

    def trees(self) -> list[dict]:
        """Each member's params as a JAX tree of numpy arrays."""
        layers = [getattr(self.classify, f"layer{i}") for i in range(2)]
        return [{"classify": {f"layer{i}": {
            "w": layer.w[m].detach().cpu().numpy().copy(),
            "b": layer.b[m, 0].detach().cpu().numpy().copy()}
            for i, layer in enumerate(layers)}}
            for m in range(self.members)]
