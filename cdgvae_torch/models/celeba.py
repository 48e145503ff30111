"""The CelebA-family CDG-VAE: a dual-latent model with five SAGAN GAM
decoders (port of ``cdgvae_tpu/models/celeba.py``).

The ResNet encoder emits 2*node causal and 2*latent_dim style posterior
parameters. The causal latents go through the SEM and flows; the style
``epsilon2`` bypasses them. Five generators decode: four over the causal
parent groups of :data:`BLOCK_GROUPS` and one over ``epsilon2``, each
masked by its segmentation channel, summed, ``tanh``. The masks come per
call from the input's channels 3-7.

Images in and out are NHWC: ``x`` [B, H, W, 3 + 5] in [0, 1], ``xhat`` and
each ``xhat_separated`` entry [B, H, W, 3]. Parameter names are the JAX
tree's (``encoder.*``, ``causal.flows.*``, ``decoder.gen{i}.*``); a tree
saved in the stacked decoder format (``decoder.stacked``) is converted
with :func:`unstack_decoder` / :func:`stack_decoder`.

Sampling noise is given (``noise=``, a :class:`CelebANoise`) or drawn from
a ``torch.Generator`` in the order: eps1, eps2, then every noise site of
generator 0, 1, ... 4. With neither, a CPU generator seeded 0 draws, so
the card and the CPU draw the same.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..nn import BatchNorm
from ..ops.causal import CausalGraph, scale_adjacency
from .resnet import ResNetEncoder
from .sagan import (Generator, Noise, sn_sites, stack_generator_trees,
                    unstack_generator_trees)


class CelebAOutput(NamedTuple):
    mean1: torch.Tensor
    logvar1: torch.Tensor
    epsilon1: torch.Tensor
    orig_latent: torch.Tensor
    latent: torch.Tensor
    logdet: torch.Tensor
    mean2: torch.Tensor
    logvar2: torch.Tensor
    epsilon2: torch.Tensor
    align_latent: torch.Tensor
    xhat_separated: Optional[tuple]
    xhat: torch.Tensor


class CelebANoise(NamedTuple):
    """Explicit draws: ``eps1`` [B, node], ``eps2`` [B, latent_dim], and
    ``decoder``, one list a generator of its sites' [B, H, W, 1] maps."""
    eps1: torch.Tensor
    eps2: torch.Tensor
    decoder: list


# decoder parent groups over the 6 causal latents
BLOCK_GROUPS = ([0, 2], [0, 3], [0, 4], [0, 1, 5])

SMILE_NODES = ["Smiling", "Male", "High_Cheekbones", "Mouth_Slightly_Open",
               "Chubby", "Narrow_Eyes"]
ATTRACTIVE_NODES = ["Young", "Male", "Bags_Under_Eyes", "Chubby",
                    "Heavy_Makeup", "Receding_Hairline"]


def celeba_B(nodes, causal_structure: int = 0,
             adjacency_scaling: bool = True) -> np.ndarray:
    """The two attribute DAGs: 0 smile, 1 attractive."""
    B = np.zeros((len(nodes), len(nodes)))
    if causal_structure == 0:
        edges = [("Smiling", "High_Cheekbones"),
                 ("Smiling", "Mouth_Slightly_Open"),
                 ("Smiling", "Chubby"), ("Smiling", "Narrow_Eyes"),
                 ("Male", "Narrow_Eyes")]
    elif causal_structure == 1:
        edges = [("Young", "Bags_Under_Eyes"), ("Young", "Chubby"),
                 ("Young", "Heavy_Makeup"), ("Young", "Receding_Hairline"),
                 ("Male", "Heavy_Makeup"), ("Male", "Receding_Hairline")]
    else:
        raise ValueError("Not supported causal structure!")
    for a, b in edges:
        B[nodes.index(a), nodes.index(b)] = 1
    return scale_adjacency(B) if adjacency_scaling else B


def _randn_like(t: torch.Tensor, generator: torch.Generator):
    return torch.randn(t.shape, generator=generator, device=generator.device,
                       dtype=t.dtype).to(t.device)


class CelebACDGVAE(nn.Module):
    def __init__(self, graph: CausalGraph, latent_dim: int = 6,
                 image_size: int = 128, conv_dim: int = 32,
                 freeze_trunk: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if graph.node != latent_dim:
            raise ValueError("epsilon2 takes node-sized draws in the "
                             "reference: node must equal latent_dim")
        kw = dict(generator=generator, device=device)
        self.node = graph.node
        self.latent_dim = latent_dim
        self.image_size = image_size
        self.K = len(BLOCK_GROUPS) + 1
        self.z_dims = [len(g) for g in BLOCK_GROUPS] + [latent_dim]
        for i, g in enumerate(BLOCK_GROUPS):  # gathered on the device
            self.register_buffer(f"_group{i}",
                                 torch.tensor(g, device=device),
                                 persistent=False)
        self.encoder = ResNetEncoder(graph.node * 2 + latent_dim * 2,
                                     freeze_trunk=freeze_trunk, **kw)
        self.causal = graph.to(device)
        self.decoder = nn.ModuleDict({
            f"gen{i}": Generator(zd, conv_dim=conv_dim,
                                 image_size=image_size, **kw)
            for i, zd in enumerate(self.z_dims)})

    @property
    def graph(self) -> CausalGraph:
        return self.causal

    def noise_shapes(self, batch_size: int) -> list[tuple]:
        """What a sampling forward draws, in its order: eps1, eps2, then
        every noise site of generator 0, 1, ... as [B, 1, H, W]
        (``train/scanned.py::NoisePlan``)."""
        return [(batch_size, self.node), (batch_size, self.latent_dim),
                *(s for i in range(self.K)
                  for s in self.decoder[f"gen{i}"].noise_shapes(batch_size))]

    def pack_noise(self, buffers: list) -> CelebANoise:
        """:meth:`noise_shapes`' buffers as a :class:`CelebANoise` (each
        site's map viewed as its [B, H, W, 1] draw)."""
        eps1, eps2, *sites = buffers
        decoder = []
        for i in range(self.K):
            n = len(self.decoder[f"gen{i}"].noise_shapes(1))
            decoder.append([t.view(t.shape[0], *t.shape[2:], 1)
                            for t in sites[:n]])
            sites = sites[n:]
        return CelebANoise(eps1, eps2, decoder)

    def get_posterior(self, x: torch.Tensor):
        """x [B, H, W, >=3]; the encoder sees the RGB channels."""
        rgb = x[..., :3].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = self.encoder(rgb)
        n, m = self.node, self.latent_dim
        return h[:, :n], h[:, n: 2 * n], h[:, 2 * n: 2 * n + m], \
            h[:, 2 * n + m:]

    def encode(self, x: torch.Tensor, noise: CelebANoise | None = None,
               generator: torch.Generator | None = None,
               deterministic: bool = False):
        """((mean1, logvar1, eps1, orig_latent, latent, logdet), (mean2,
        logvar2, eps2)); eps = mean when ``deterministic`` or without
        noise and generator."""
        mean1, logvar1, mean2, logvar2 = self.get_posterior(x)
        if deterministic or (noise is None and generator is None):
            eps1, eps2 = mean1, mean2
        else:
            if noise is not None:
                n1, n2 = (torch.as_tensor(np.array(n)).to(m)
                          if not torch.is_tensor(n) else n.to(m)
                          for n, m in ((noise.eps1, mean1),
                                       (noise.eps2, mean2)))
            else:
                n1 = _randn_like(mean1, generator)
                n2 = _randn_like(mean2, generator)
            eps1 = mean1 + torch.exp(logvar1 / 2.0) * n1
            eps2 = mean2 + torch.exp(logvar2 / 2.0) * n2
        orig_latent, latent, logdet = self.causal.transform(eps1)
        return (mean1, logvar1, eps1, orig_latent, latent, logdet), \
            (mean2, logvar2, eps2)

    def decode(self, latent: torch.Tensor, epsilon2: torch.Tensor,
               masks: torch.Tensor, noise) -> tuple:
        """latent [B, node], epsilon2 [B, latent_dim], masks [B, H, W, 5];
        ``noise`` a ``torch.Generator`` or one list of site draws a
        generator. Returns (xhat_separated, xhat), NHWC."""
        inputs = [latent.index_select(1, getattr(self, f"_group{i}"))
                  for i in range(len(BLOCK_GROUPS))] + [epsilon2]
        shared = Noise(noise) if isinstance(noise, torch.Generator) else None
        masks = masks.permute(0, 3, 1, 2)
        seps, total = [], 0.0
        for i, z in enumerate(inputs):
            img = self.decoder[f"gen{i}"](
                z, shared if shared is not None else Noise(noise[i]))
            seps.append(img.permute(0, 2, 3, 1))
            total = total + img * masks[:, i: i + 1]
        return tuple(seps), torch.tanh(total).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, noise: CelebANoise | None = None,
                generator: torch.Generator | None = None,
                deterministic: bool = False) -> CelebAOutput:
        if noise is None and generator is None:
            generator = torch.Generator().manual_seed(0)
        (mean1, logvar1, eps1, orig_latent, latent, logdet), \
            (mean2, logvar2, eps2) = self.encode(x, noise, generator,
                                                 deterministic)
        masks = x[..., 3: 3 + self.K]
        xhat_separated, xhat = self.decode(
            latent, eps2, masks,
            noise.decoder if noise is not None else generator)
        _, align_latent, _ = self.causal.transform(mean1)
        return CelebAOutput(mean1, logvar1, eps1, orig_latent, latent,
                            logdet, mean2, logvar2, eps2, align_latent,
                            xhat_separated, xhat)

    def adapt_to(self, tree: dict) -> "CelebACDGVAE":
        """Make the module's leaves those of a canonical (per-generator)
        param tree about to be loaded: an SN site without ``v`` becomes a
        legacy site, and a BatchNorm with ``mean``/``var`` (a torchvision
        import) gains those buffers."""
        def node(path):
            t = tree
            for key in path.split("."):
                t = t[key]
            return t

        for name, site in sn_sites(self):
            if "v" not in node(name):
                site.make_legacy()
        for name, m in self.encoder.named_modules():
            if isinstance(m, BatchNorm) and m.mean is None:
                sub = node(f"encoder.{name}")
                if "mean" in sub:
                    m.set_running_stats(sub["mean"], sub["var"])
        return self


def is_stacked(tree: dict) -> bool:
    return "stacked" in tree["decoder"]


def unstack_decoder(tree: dict, z_dims) -> dict:
    """A param (or Adam moment) tree with ``decoder.stacked`` -> the same
    tree with ``decoder.gen{i}``; others pass through."""
    if not is_stacked(tree):
        return tree
    trees = unstack_generator_trees(tree["decoder"]["stacked"], z_dims)
    return {**tree, "decoder": {f"gen{i}": t for i, t in enumerate(trees)}}


def stack_decoder(tree: dict, z_dims) -> dict:
    """The inverse of :func:`unstack_decoder`."""
    if is_stacked(tree):
        return tree
    trees = [tree["decoder"][f"gen{i}"] for i in range(len(z_dims))]
    return {**tree, "decoder": {
        "stacked": stack_generator_trees(trees, max(z_dims))}}
