"""Pendulum-family VAE models: the baseline VAE and CDG-VAE with the masked
GAM decoder.

Port of ``cdgvae_tpu/models/vae.py:36-315`` as ``nn.Module``s whose
parameter names match the JAX pytree (``encoder.layer0.w``,
``causal.flows.p``, ``decoder.layer0.w``, ``decoder.out.w0`` ...), so a JAX
param tree loads by copy (``utils/interop.py``). As in the reference:

* the K per-factor GAM decoders run as one stacked batched matmul; latent
  blocks are gathered by static index lists, zero-padded to equal width;
* when the decoder masks are an exact row-band partition (the pendulum
  masks are), the final layer stores only each block's live output band
  (``decoder.out.w{k}/b{k}``), sliced from the same stacked draw;
* the alignment branch re-uses the posterior mean.

Sampling noise is either given (``noise=``, a [batch, node] tensor) or drawn
from an explicit ``torch.Generator`` (``generator=``); with neither, the
encoder is deterministic (epsilon = mean).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import MLP, StackedDense, stacked_dense
from ..ops.causal import CausalGraph


class VAEOutput(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor
    epsilon: torch.Tensor
    orig_latent: torch.Tensor
    latent: torch.Tensor          # [batch, node]
    logdet: torch.Tensor          # [batch, node]
    align_latent: torch.Tensor    # [batch, node]
    xhat_separated: Optional[torch.Tensor]  # [K, batch, out] or None
    xhat: torch.Tensor            # [batch, H, W, 3]


def default_block_indices(factor: Sequence[int]) -> list[list[int]]:
    """Contiguous latent blocks from the ``factor`` split."""
    out, start = [], 0
    for k in factor:
        out.append(list(range(start, start + k)))
        start += k
    return out


class _EpsilonNoise:
    """What a pendulum model's training forward draws: epsilon's
    [batch, node] normal (``train/scanned.py::NoisePlan``)."""

    def noise_shapes(self, batch_size: int) -> list[tuple]:
        return [(batch_size, self.node)]

    @staticmethod
    def pack_noise(buffers: list):
        return buffers[0]


class VAE(_EpsilonNoise, nn.Module):
    """Baseline VAE: MLP encoder/decoder + causal latent layer."""

    def __init__(self, graph: CausalGraph, image_size: int = 64,
                 hidden: int = 300, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.node = graph.node
        self.image_size = image_size
        self.in_dim = 3 * image_size * image_size
        self.encoder = MLP([self.in_dim, hidden, hidden, self.node * 2],
                           generator=generator, device=device)
        self.causal = graph.to(device)
        self.decoder = MLP([self.node, hidden, hidden, self.in_dim],
                           generator=generator, device=device)

    @property
    def graph(self) -> CausalGraph:
        return self.causal

    def get_posterior(self, x: torch.Tensor):
        h = self.encoder(x.reshape(x.shape[0], -1))
        return h[:, : self.node], h[:, self.node:]

    def encode(self, x: torch.Tensor, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               deterministic: bool = False):
        mean, logvar = self.get_posterior(x)
        if deterministic or (noise is None and generator is None):
            epsilon = mean
        else:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    dtype=mean.dtype, device=mean.device)
            # the reference draws in mean's dtype: a given draw takes it
            epsilon = mean + torch.exp(logvar / 2.0) * noise.to(mean.dtype)
        orig_latent, latent, logdet = self.graph.transform(epsilon)
        return mean, logvar, epsilon, orig_latent, latent, logdet

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        xhat = self.decoder(latent, final_activation=torch.tanh)
        return xhat.reshape(-1, self.image_size, self.image_size, 3)

    def decode_fast(self, latent: torch.Tensor) -> torch.Tensor:
        """The images alone, as ``CDGVAE.decode_fast``; the VAE has no
        per-block outputs to skip."""
        return self.decode(latent)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                deterministic: bool = False, fast: bool = False
                ) -> VAEOutput:
        """``fast`` is taken for a call common to both models and changes
        nothing here."""
        mean, logvar, epsilon, orig_latent, latent, logdet = self.encode(
            x, noise, generator, deterministic)
        xhat = self.decode(latent)
        _, align_latent, _ = self.graph.transform(mean)
        return VAEOutput(mean, logvar, epsilon, orig_latent, latent, logdet,
                         align_latent, None, xhat)


class CDGVAE(_EpsilonNoise, nn.Module):
    """CDG-VAE: shared encoder + K masked per-factor GAM decoders.

    ``masks``: [K, H, W, 3] spatial masks. ``block_indices``: which latent
    dims feed each decoder block; defaults to the contiguous ``factor``
    split.
    """

    def __init__(self, graph: CausalGraph, masks, factor: Sequence[int],
                 image_size: int = 64, hidden: int = 300,
                 block_indices: Optional[list[list[int]]] = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if block_indices is None:
            if sum(factor) != graph.node:
                raise ValueError(f"factor {list(factor)} does not sum to "
                                 f"node={graph.node}")
            block_indices = default_block_indices(factor)
        masks = np.asarray(masks, dtype=np.float32)
        if not len(factor) == len(block_indices) == masks.shape[0]:
            raise ValueError("factor, block_indices and masks disagree on "
                             "the number of decoder blocks")

        self.node = graph.node
        self.K = len(block_indices)
        self.image_size = image_size
        self.out_dim = 3 * image_size * image_size
        self.kmax = max(len(b) for b in block_indices)
        gather = np.zeros((self.K, self.kmax), dtype=np.int64)
        valid = np.zeros((self.K, self.kmax), dtype=np.float32)
        for i, blk in enumerate(block_indices):
            gather[i, : len(blk)] = blk
            valid[i, : len(blk)] = 1.0
        self.register_buffer("masks", torch.as_tensor(masks, device=device),
                             persistent=False)
        self.register_buffer("_gather", torch.as_tensor(gather, device=device),
                             persistent=False)
        self.register_buffer("_valid", torch.as_tensor(valid, device=device),
                             persistent=False)
        self._bands = self._detect_row_bands(masks)

        self.encoder = MLP([self.out_dim, hidden, hidden, self.node * 2],
                           generator=generator, device=device)
        self.causal = graph.to(device)
        # hidden layers layer0, layer1 stacked over K; the final layer is
        # either band-sliced (decoder.out.w{k}/b{k}) or stacked (layer2)
        sizes = [self.kmax, hidden, hidden, self.out_dim]
        self.decoder = nn.ModuleDict({
            f"layer{i}": StackedDense(self.K, sizes[i], sizes[i + 1],
                                      generator=generator, device=device)
            for i in range(len(sizes) - 1)})
        self._n_hidden = len(sizes) - 2
        if self._bands is not None:
            last = self.decoder.pop(f"layer{self._n_hidden}")
            out = nn.ParameterDict()
            for k, (c0, c1) in enumerate(self._bands):
                out[f"w{k}"] = nn.Parameter(last.w.data[k, :, c0:c1].clone())
                out[f"b{k}"] = nn.Parameter(last.b.data[k, 0, c0:c1].clone())
            self.decoder["out"] = out

    @property
    def graph(self) -> CausalGraph:
        return self.causal

    @staticmethod
    def _detect_row_bands(masks: np.ndarray):
        """Per-block flat (start, end) output ranges if masks are a
        contiguous, ordered, exact row partition; else None."""
        k, H, W, C = masks.shape
        expect_start = 0
        bands = []
        for i in range(k):
            rows = np.where(masks[i].reshape(H, -1).any(axis=1))[0]
            if len(rows) == 0:
                return None
            r0, r1 = rows.min(), rows.max() + 1
            band = np.zeros_like(masks[i])
            band[r0:r1] = 1.0
            if not np.array_equal(band, masks[i]) or r0 != expect_start:
                return None
            expect_start = r1
            bands.append((int(r0 * W * C), int(r1 * W * C)))
        if expect_start != H:
            return None
        return bands

    get_posterior = VAE.get_posterior
    encode = VAE.encode

    def _decoder_hidden(self, latent: torch.Tensor) -> torch.Tensor:
        """[batch, node] -> [K, batch, hidden]."""
        blocks = latent[:, self._gather] * self._valid   # [batch, K, kmax]
        h = blocks.permute(1, 0, 2)                      # [K, batch, kmax]
        for i in range(self._n_hidden):
            h = F.elu(self.decoder[f"layer{i}"](h))
        return h

    def _band_pieces(self, h: torch.Tensor) -> list[torch.Tensor]:
        """[K, batch, hidden] -> per-band final-layer outputs."""
        out = self.decoder["out"]
        # in h's dtype: under a bf16 cast_compute h is float32 and the
        # weights bf16, which JAX promotes (see nn.stacked_dense)
        return [h[k] @ out[f"w{k}"].to(h.dtype) + out[f"b{k}"]
                for k in range(self.K)]

    def _image(self, flat: torch.Tensor) -> torch.Tensor:
        return flat.reshape(-1, self.image_size, self.image_size, 3)

    def decode(self, latent: torch.Tensor):
        """latent [batch, node] -> (xhat_separated [K, batch, out], xhat).

        With a band-sliced final layer the masked sum is a concatenation of
        the per-band outputs; xhat_separated is zero outside each band."""
        h = self._decoder_hidden(latent)
        if self._bands is not None:
            pieces = self._band_pieces(h)
            xhat_sep = h.new_zeros((self.K, h.shape[1], self.out_dim))
            for k, (c0, c1) in enumerate(self._bands):
                xhat_sep[k, :, c0:c1] = pieces[k]
            return xhat_sep, torch.tanh(self._image(torch.cat(pieces, 1)))
        last = self.decoder[f"layer{self._n_hidden}"]
        xhat_sep = stacked_dense(last.w, last.b, h)      # [K, batch, out]
        imgs = xhat_sep.reshape(self.K, -1, self.image_size, self.image_size,
                                3)
        xhat = torch.tanh((imgs * self.masks[:, None]).sum(dim=0))
        return xhat_sep, xhat

    def decode_fast(self, latent: torch.Tensor) -> torch.Tensor:
        """Band-sliced decode without the [K, batch, out] scatter; the
        masked path when the masks are not a row partition."""
        if self._bands is None:
            return self.decode(latent)[1]
        h = self._decoder_hidden(latent)
        return torch.tanh(self._image(torch.cat(self._band_pieces(h), 1)))

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                deterministic: bool = False, fast: bool = False) -> VAEOutput:
        mean, logvar, epsilon, orig_latent, latent, logdet = self.encode(
            x, noise, generator, deterministic)
        if fast:
            xhat_separated, xhat = None, self.decode_fast(latent)
        else:
            xhat_separated, xhat = self.decode(latent)
        _, align_latent, _ = self.graph.transform(mean)
        return VAEOutput(mean, logvar, epsilon, orig_latent, latent, logdet,
                         align_latent, xhat_separated, xhat)


def pendulum_masks(image_size: int = 64, k: int = 3) -> np.ndarray:
    """The fixed pendulum decoder masks: light rows [0:20), angle [20:51),
    shadow [51:) at 64 px, scaled proportionally for other sizes."""
    bounds = [0, 20, 51, image_size]
    if k != len(bounds) - 1:
        raise ValueError(
            f"pendulum defines exactly {len(bounds) - 1} decoder masks "
            f"(light/angle/shadow row bands); got a factor list of "
            f"length k={k} — use --factor with 3 blocks for this family")
    if image_size != 64:
        bounds = [int(round(b * image_size / 64)) for b in bounds]
    masks = np.zeros((k, image_size, image_size, 3), dtype=np.float32)
    for i in range(k):
        masks[i, bounds[i]: bounds[i + 1]] = 1.0
    return masks
