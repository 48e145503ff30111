"""Tabular-family models: VAE, CDG-VAE, CDG-TVAE and the InfoMax
discriminator (port of ``cdgvae_tpu/models/tabular.py``).

Tiny MLPs (widths 2-32) with per-dataset depths. The CDG-VAE's and the
TVAE's decoder blocks each have their own output width (the ``mask`` of
output column counts), so they run one after another and their outputs are
concatenated, not masked. ``nn.Module``s whose parameter names match the
JAX pytrees (``encoder.layer0.w``, ``causal.flows.p``, ``decoder.layer0.w``
or ``decoder.block0.layer0.w``, the TVAE's ``sigma``, the discriminator's
``net.layer0.w``), so a JAX param tree loads by copy
(``utils/interop.py``). The reparameterisation
noise is given (``noise=``) or drawn from ``generator=``, as in
``models/vae.py``; ``noise_shapes``/``pack_noise`` name that draw, epsilon's
[batch, node] normal, for the graphed epoch runner
(``train/scanned.py::NoisePlan``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import MLP
from ..ops.causal import CausalGraph
from .vae import VAE, VAEOutput, _EpsilonNoise


def _encoder_sizes(dataset: str, input_dim: int, node: int):
    if dataset == "covtype":
        return [input_dim, 4, 4, 4, node * 2]
    return [input_dim, 4, node * 2]


def _decoder_sizes(dataset: str, node: int, input_dim: int):
    if dataset == "loan":
        return [node, 4, input_dim]
    if dataset == "adult":
        return [node, 8, 8, 16, input_dim]
    if dataset == "covtype":
        return [node, 8, 8, 16, input_dim - 1 + 7]
    raise ValueError("Not supported dataset!")


class TabularVAE(_EpsilonNoise, nn.Module):
    """Single-decoder tabular VAE."""

    def __init__(self, graph: CausalGraph, dataset: str, input_dim: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.node = graph.node
        self.dataset = dataset
        self.input_dim = input_dim
        self.encoder = MLP(_encoder_sizes(dataset, input_dim, self.node),
                           generator=generator, device=device)
        self.causal = graph.to(device)
        self.decoder = MLP(_decoder_sizes(dataset, self.node, input_dim),
                           generator=generator, device=device)

    @property
    def graph(self) -> CausalGraph:
        return self.causal

    get_posterior = VAE.get_posterior
    encode = VAE.encode

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        return self.decoder(latent)

    def decode_fast(self, latent: torch.Tensor) -> torch.Tensor:
        """The output columns [batch, out] (what serving returns)."""
        return self.decode(latent)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                deterministic: bool = False, fast: bool = False
                ) -> VAEOutput:
        """``fast`` is taken for a call common to every model and changes
        nothing here."""
        mean, logvar, epsilon, orig_latent, latent, logdet = self.encode(
            x, noise, generator, deterministic)
        xhat = self.decode(latent)
        _, align_latent, _ = self.graph.transform(mean)
        return VAEOutput(mean, logvar, epsilon, orig_latent, latent, logdet,
                         align_latent, None, xhat)


class TabularCDGVAE(_EpsilonNoise, nn.Module):
    """Per-factor block decoders ``decoder.block{i}``, block i mapping its
    ``factor[i]`` latents to ``mask[i]`` output columns."""

    def __init__(self, graph: CausalGraph, dataset: str, input_dim: int,
                 factor: Sequence[int], mask: Sequence[int], *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if sum(factor) != graph.node or len(factor) != len(mask):
            raise ValueError(f"factor {list(factor)} must sum to node "
                             f"{graph.node} and match mask {list(mask)}")
        self.node = graph.node
        self.dataset = dataset
        self.input_dim = input_dim
        self.factor = tuple(factor)
        self.mask = tuple(mask)
        self.K = len(factor)
        self.encoder = MLP(_encoder_sizes(dataset, input_dim, self.node),
                           generator=generator, device=device)
        self.causal = graph.to(device)
        self.decoder = nn.ModuleDict({
            f"block{i}": MLP(self._block_sizes(i, self.factor[i],
                                               self.mask[i]),
                             generator=generator, device=device)
            for i in range(self.K)})

    def _block_sizes(self, i: int, k: int, m: int):
        if self.dataset == "covtype":
            if i == self.K - 1:  # a deeper last block
                return [k, 4, 4, 8, m]
            return [k, 2, 2, m]
        return [k, 2, m]

    @property
    def graph(self) -> CausalGraph:
        return self.causal

    get_posterior = VAE.get_posterior
    encode = VAE.encode

    def decode(self, latent: torch.Tensor):
        """Returns (xhat_separated, a list of each block's [batch, mask[i]],
        and xhat, their concatenation [batch, sum(mask)])."""
        outs = [self.decoder[f"block{i}"](z)
                for i, z in enumerate(latent.split(self.factor, dim=1))]
        return outs, torch.cat(outs, dim=1)

    def decode_fast(self, latent: torch.Tensor) -> torch.Tensor:
        """The concatenated output columns alone."""
        return self.decode(latent)[1]

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                deterministic: bool = False, fast: bool = False
                ) -> VAEOutput:
        mean, logvar, epsilon, orig_latent, latent, logdet = self.encode(
            x, noise, generator, deterministic)
        xhat_separated, xhat = self.decode(latent)
        _, align_latent, _ = self.graph.transform(mean)
        return VAEOutput(mean, logvar, epsilon, orig_latent, latent, logdet,
                         align_latent, xhat_separated, xhat)


class TVAE(_EpsilonNoise, nn.Module):
    """CDG-TVAE: a tabular VAE over DataTransformer encodings with a
    learnable observation noise ``sigma`` [input_dim] (initialised to 0.1)
    per encoded column. Encoder ``[input_dim, 32, 16, 16, 2·node]`` and
    decoder blocks ``decoder.block{i}`` ``[factor[i], 8, 8, 16, mask[i]]``,
    ReLU between layers. The decoder's output is raw: the loss reads the
    tanh columns through ``tanh`` and the softmax spans as logits."""

    def __init__(self, graph: CausalGraph, input_dim: int,
                 factor: Sequence[int], mask: Sequence[int], *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if sum(factor) != graph.node or len(factor) != len(mask):
            raise ValueError(f"factor {list(factor)} must sum to node "
                             f"{graph.node} and match mask {list(mask)}")
        self.node = graph.node
        self.input_dim = input_dim
        self.factor = tuple(factor)
        self.mask = tuple(mask)
        self.K = len(factor)
        self.encoder = MLP([input_dim, 32, 16, 16, self.node * 2],
                           generator=generator, device=device)
        self.causal = graph.to(device)
        self.decoder = nn.ModuleDict({
            f"block{i}": MLP([self.factor[i], 8, 8, 16, self.mask[i]],
                             generator=generator, device=device)
            for i in range(self.K)})
        self.sigma = nn.Parameter(torch.full((input_dim,), 0.1,
                                             device=device))

    @property
    def graph(self) -> CausalGraph:
        return self.causal

    def get_posterior(self, x: torch.Tensor):
        h = self.encoder(x, activation=F.relu)
        return h[:, : self.node], h[:, self.node:]

    encode = VAE.encode

    def decode(self, latent: torch.Tensor):
        """(xhat_separated, each block's [batch, mask[i]]; xhat, their
        concatenation [batch, input_dim])."""
        outs = [self.decoder[f"block{i}"](z, activation=F.relu)
                for i, z in enumerate(latent.split(self.factor, dim=1))]
        return outs, torch.cat(outs, dim=1)

    def decode_fast(self, latent: torch.Tensor) -> torch.Tensor:
        """The concatenated raw output columns alone."""
        return self.decode(latent)[1]

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                deterministic: bool = False, fast: bool = False
                ) -> VAEOutput:
        """``fast`` is taken for a call common to every model and changes
        nothing here."""
        mean, logvar, epsilon, orig_latent, latent, logdet = self.encode(
            x, noise, generator, deterministic)
        xhat_separated, xhat = self.decode(latent)
        _, align_latent, _ = self.graph.transform(mean)
        return VAEOutput(mean, logvar, epsilon, orig_latent, latent, logdet,
                         align_latent, xhat_separated, xhat)


class TabularDiscriminator(nn.Module):
    """InfoMax discriminator: an MLP on ``cat(x, z)``, input_dim + node ->
    4 -> 1."""

    def __init__(self, input_dim: int, node: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.input_dim = input_dim
        self.node = node
        self.net = MLP([input_dim + node, 4, 1], generator=generator,
                       device=device)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """x [batch, input_dim], z [batch, node] -> [batch, 1]."""
        return self.net(torch.cat([x.reshape(x.shape[0], -1), z], dim=1))
