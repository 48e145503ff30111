"""SAGAN building blocks: spectral-norm linear and conv sites, the
generator's layers and ``Generator``, the stacked-decoder checkpoint
format, and the three discriminators (port of ``cdgvae_tpu/models/
sagan.py``).

Parameters keep the JAX tree's names and layouts (``utils/interop.py``
copies them one to one): a spectral-norm (SN) site is ``{w, b, u, v}``
with ``w`` [in, out] (linear) or HWIO (conv); ``u``/``v`` are buffers, not
trained parameters, yet part of the exported tree and of the Adam state
(with zero moments, as optax keeps for them). Activations are NCHW
tensors; the images these models take and give are NHWC.

As in the JAX package:

* spectral norm is stateful: the forward computes ``sigma = u @ W2d @ v``
  with ``W2d`` the [out, h*w*in] flattening (``reshape(-1, out).T``, so
  ``v`` is in h*w*in order) and ``u``, ``v`` constants; ``sn_refresh``
  advances every site one power iteration after each optimizer step,
  outside autograd. A legacy site (a checkpoint without ``v``) keeps
  estimating sigma in its forward with 3 power iterations from ``u``;
* BatchNorm always uses batch statistics;
* init is orthogonal with zero bias, and the SN state is warm-started
  with 3 power iterations.

Noise injection draws one [B, 1, H, W] map a site, from a
``torch.Generator`` or from explicit draws in site order ([B, H, W, 1]
each, as the JAX package draws them): block0's, then each block's
``noise1`` and ``noise2``.

The stacked decoder format (``decoder.stacked``: the five generators'
trees stacked on a leading axis, ``block0.linear``'s input rows
zero-padded to the widest) is a checkpoint format here: it is unstacked
on load (:func:`unstack_generator_trees`) into the per-generator modules
and restacked on save (:func:`stack_generator_trees`). Both are exact:
padded rows have zero gradient and zero Adam moments, and ``v``'s refresh
lands exactly 0 there. Evaluating the five generators as one grouped
program is not ported.
"""
from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Conv2d, Dense, hwio_conv2d

SN_POWER_ITERS = 3


def orthogonal(shape, generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """Orthogonal init of a linear [in, out] or HWIO conv kernel over its
    (out, h*w*in) flattening, as ``sagan.py::_orthogonal`` does."""
    flat = tuple(shape) if len(shape) == 2 else \
        (shape[3], shape[0] * shape[1] * shape[2])
    a = torch.randn((max(flat), min(flat)), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    q = q[: flat[0], : flat[1]] if flat[0] >= flat[1] else \
        q[: flat[1], : flat[0]].T
    if len(shape) == 2:
        q = q.reshape(shape)
    else:
        q = q.reshape(shape[3], shape[0], shape[1], shape[2]).permute(
            1, 2, 3, 0)
    return q.contiguous().to(device)


def _w2d(w: torch.Tensor) -> torch.Tensor:
    """[out, flattened-in] view of an SN weight."""
    if w.ndim == 2:
        return w.T
    return w.reshape(-1, w.shape[-1]).T


def power_iterate(w2d: torch.Tensor, u: torch.Tensor, iters: int):
    """``iters`` power iterations from ``u``; returns (u, v) normalised."""
    if iters < 1:
        raise ValueError("power iteration needs iters >= 1")
    for _ in range(iters):
        v = w2d.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = w2d @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    return u, v


class SNSite(nn.Module):
    """One spectral-norm site: ``w``, ``b`` parameters, ``u``, ``v``
    buffers."""

    def __init__(self, w_shape, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        out = w_shape[-1]
        self.w = nn.Parameter(orthogonal(w_shape, generator, device))
        self.b = nn.Parameter(torch.zeros(out, device=device))
        self.register_buffer("u", torch.randn(out, generator=generator)
                             .to(device))
        self.register_buffer("v", torch.zeros(math.prod(w_shape[:-1]),
                                              device=device))
        self.refresh(SN_POWER_ITERS)  # warm-start u, v

    def make_legacy(self):
        """Drop ``v``: the site then estimates sigma in its forward, as a
        checkpoint from before the stored ``v`` does."""
        self.v = None

    def sigma(self, w: torch.Tensor) -> torch.Tensor:
        w2d = _w2d(w)
        if self.v is None:  # legacy: power-iterate in the forward
            with torch.no_grad():
                u, v = power_iterate(w2d, self.u.to(w.dtype), SN_POWER_ITERS)
            return u @ w2d @ v
        return self.u @ w2d @ self.v

    def normalized(self) -> torch.Tensor:
        return self.w / self.sigma(self.w)

    @torch.no_grad()
    def refresh(self, iters: int = 1):
        """Advance (u, v) by ``iters`` power iterations from the current
        weight; a legacy site is left as it is."""
        if self.v is None:
            return
        u, v = power_iterate(_w2d(self.w), self.u, iters)
        self.u.copy_(u)
        self.v.copy_(v)


class SNLinear(SNSite):
    def __init__(self, in_f: int, out_f: int, **kw):
        super().__init__((in_f, out_f), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.normalized() + self.b


class SNConv(SNSite):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, **kw):
        super().__init__((kernel, kernel, in_ch, out_ch), **kw)

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return hwio_conv2d(x, self.normalized(), self.b, stride)


def sn_sites(module: nn.Module) -> Iterable[tuple[str, SNSite]]:
    return ((n, m) for n, m in module.named_modules()
            if isinstance(m, SNSite))


@torch.no_grad()
def sn_refresh(module: nn.Module, iters: int = 1):
    """The post-update hook: refresh every stateful SN site in
    ``module``; legacy sites keep estimating in their forward."""
    for _, site in sn_sites(module):
        site.refresh(iters)


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

class Noise:
    """What the noise sites draw from: a ``torch.Generator`` (a [B, 1, H,
    W] normal map a site, drawn on the generator's device and moved to the
    activation's), or explicit draws in site order, each [B, H, W, 1]."""

    def __init__(self, source):
        self.generator = source if isinstance(source, torch.Generator) \
            else None
        self._draws = None if self.generator is not None else iter(source)

    def draw(self, like: torch.Tensor) -> torch.Tensor:
        B, _, H, W = like.shape
        if self.generator is not None:
            g = self.generator
            return torch.randn((B, 1, H, W), generator=g, device=g.device,
                               dtype=like.dtype).to(like.device)
        n = next(self._draws)
        if not torch.is_tensor(n):
            n = torch.from_numpy(np.array(n))
        if tuple(n.shape) != (B, H, W, 1):
            raise ValueError(f"noise draw {tuple(n.shape)} for a site of "
                             f"{(B, H, W, 1)}")
        return n.permute(0, 3, 1, 2).to(like)


class NoiseInjection(nn.Module):
    """``x + weight * noise``, ``weight`` [1, 1, 1, ch] (zeros at init)."""

    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, 1, 1, ch, device=device))

    def forward(self, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        return x + self.weight.permute(0, 3, 1, 2) * noise.draw(x)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _maxpool2(x):
    return F.max_pool2d(x, 2)


def upsample2(x):
    """Nearest 2x upsample: output (i, j) reads input (i // 2, j // 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SelfAttn(nn.Module):
    """Spatial self-attention (``sagan.py:188-206``); ``sigma`` [1] (zero
    at init) gates the attended features."""

    def __init__(self, in_ch: int, **kw):
        super().__init__()
        self.theta = SNConv(in_ch, in_ch // 8, 1, **kw)
        self.phi = SNConv(in_ch, in_ch // 8, 1, **kw)
        self.g = SNConv(in_ch, in_ch // 2, 1, **kw)
        self.attn = SNConv(in_ch // 2, in_ch, 1, **kw)
        self.sigma = nn.Parameter(torch.zeros(1, device=kw.get("device")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)       # [B, HW, C/8]
        phi = _maxpool2(self.phi(x)).flatten(2)                # [B, C/8, HW/4]
        attn = torch.softmax(theta @ phi, dim=-1)              # [B, HW, HW/4]
        g = _maxpool2(self.g(x)).flatten(2).transpose(1, 2)    # [B, HW/4, C/2]
        attn_g = (attn @ g).transpose(1, 2).reshape(B, C // 2, H, W)
        return x + self.sigma * self.attn(attn_g)


class GenIniBlock(nn.Module):
    """z -> SN linear -> [B, ch, 4, 4] (+ noise)."""

    def __init__(self, z_dim: int, out_ch: int, add_noise: bool = True,
                 **kw):
        super().__init__()
        self.linear = SNLinear(z_dim, out_ch * 4 * 4, **kw)
        self.noise = NoiseInjection(out_ch, device=kw.get("device")) \
            if add_noise else None

    def forward(self, z: torch.Tensor, noise: Noise) -> torch.Tensor:
        x = self.linear(z).reshape(z.shape[0], 4, 4, -1).permute(0, 3, 1, 2)
        if self.noise is not None:
            x = self.noise(x, noise)
        return x


class GenBlock(nn.Module):
    """Residual upsample block (``sagan.py:249-265``)."""

    def __init__(self, in_ch: int, out_ch: int, add_noise: bool = True,
                 **kw):
        super().__init__()
        device = kw.get("device")
        self.conv1 = SNConv(in_ch, out_ch, 3, **kw)
        self.conv2 = SNConv(out_ch, out_ch, 3, **kw)
        self.conv0 = SNConv(in_ch, out_ch, 1, **kw)
        self.bn1 = BatchNorm(in_ch, device=device)
        self.bn2 = BatchNorm(out_ch, device=device)
        self.add_noise = add_noise
        if add_noise:
            self.noise1 = NoiseInjection(out_ch, device=device)
            self.noise2 = NoiseInjection(out_ch, device=device)

    def forward(self, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        h = self.conv1(upsample2(F.relu(self.bn1(x))))
        if self.add_noise:
            h = self.noise1(h, noise)
        h = self.conv2(F.relu(self.bn2(h)))
        if self.add_noise:
            h = self.noise2(h, noise)
        return h + self.conv0(upsample2(x))


def generator_schedule(conv_dim: int, image_size: int):
    """(blocks [(in, out)], attn_after, final_ch) of ``Generator``'s
    ``image_size`` (16/32/64/128/256/512)."""
    cd = conv_dim
    if image_size == 16:
        return [(cd * 16, cd * 16), (cd * 16, cd * 8)], 1, cd * 8
    if image_size == 32:
        return ([(cd * 16, cd * 16), (cd * 16, cd * 8), (cd * 8, cd * 4)],
                2, cd * 4)
    if image_size == 64:
        return ([(cd * 16, cd * 16), (cd * 16, cd * 8), (cd * 8, cd * 4),
                 (cd * 4, cd * 2)], 2, cd * 2)
    if image_size == 128:
        return ([(cd * 16, cd * 16), (cd * 16, cd * 8), (cd * 8, cd * 4),
                 (cd * 4, cd * 2), (cd * 2, cd)], 2, cd)
    blocks = [(cd * 16, cd * 16), (cd * 16, cd * 8), (cd * 8, cd * 8),
              (cd * 8, cd * 4), (cd * 4, cd * 2), (cd * 2, cd)]
    if image_size != 256:
        blocks.append((cd, cd))
    return blocks, 3, cd


class Generator(nn.Module):
    """SAGAN Generator 4x4 -> image_size, z [B, latent_dim] -> tanh image
    [B, out_channels, H, W] (``sagan.py:267-345``)."""

    def __init__(self, latent_dim: int, conv_dim: int = 32,
                 image_size: int = 128, out_channels: int = 3,
                 add_noise: bool = True, attn: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.latent_dim = latent_dim
        self.image_size = image_size
        self.blocks, self.attn_after, final_ch = generator_schedule(
            conv_dim, image_size)
        self.block0 = GenIniBlock(latent_dim, conv_dim * 16, add_noise, **kw)
        for i, (ic, oc) in enumerate(self.blocks):
            self.add_module(f"block{i + 1}", GenBlock(ic, oc, add_noise,
                                                      **kw))
        self.self_attn1 = SelfAttn(self.blocks[self.attn_after][1], **kw) \
            if attn else None
        self.bn = BatchNorm(final_ch, device=device)
        self.toRGB = SNConv(final_ch, out_channels, 3, **kw)

    def forward(self, z: torch.Tensor, noise: Noise) -> torch.Tensor:
        x = self.block0(z, noise)
        for i in range(len(self.blocks)):
            x = getattr(self, f"block{i + 1}")(x, noise)
            if self.self_attn1 is not None and i == self.attn_after:
                x = self.self_attn1(x)
        return torch.tanh(self.toRGB(F.relu(self.bn(x))))


# ---------------------------------------------------------------------------
# The stacked decoder format (checkpoints only)
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _pad_rows(a, rows: int):
    """``a`` zero-padded on its first axis to ``rows``."""
    if torch.is_tensor(a):
        out = a.new_zeros((rows,) + tuple(a.shape[1:]))
    else:
        out = np.zeros((rows,) + a.shape[1:], np.asarray(a).dtype)
    out[: len(a)] = a
    return out


def stack_generator_trees(trees: list, zmax: int) -> dict:
    """K per-generator trees (numpy arrays or tensors) -> one tree whose
    leaves carry a leading K axis, ``block0.linear``'s ``w`` and ``v``
    zero-padded to ``zmax`` input rows (``sagan.py:350-378``)."""
    padded = []
    for t in trees:
        lin = dict(t["block0"]["linear"])
        lin["w"] = _pad_rows(lin["w"], zmax)
        if "v" in lin:
            lin["v"] = _pad_rows(lin["v"], zmax)
        padded.append({**t, "block0": {**t["block0"], "linear": lin}})
    return _map(lambda *xs: torch.stack(xs) if torch.is_tensor(xs[0])
                else np.stack(xs), *padded)


def unstack_generator_trees(stacked: dict, z_dims) -> list:
    """The inverse of :func:`stack_generator_trees`: slice generator k out
    of every leaf and drop ``block0.linear``'s padded input rows."""
    trees = []
    for k, zd in enumerate(z_dims):
        t = _map(lambda a: a[k], stacked)
        lin = t["block0"]["linear"]
        lin["w"] = lin["w"][:zd]
        if "v" in lin:
            lin["v"] = lin["v"][:zd]
        trees.append(t)
    return trees


# ---------------------------------------------------------------------------
# Discriminators (shipped, unused in training, as in the JAX package)
# ---------------------------------------------------------------------------

class Discriminator(nn.Module):
    """SAGAN discriminator: strided 4x4 SN convs down to 4x4, attention
    after the second, a global sum, an SN linear -> [B, 1]. Images NHWC."""

    def __init__(self, conv_dim: int = 32, image_size: int = 128,
                 in_channels: int = 3, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        cd = conv_dim
        chans = [in_channels, cd, cd * 2, cd * 4, cd * 8, cd * 16]
        n_down = {64: 4, 128: 5, 256: 6}[image_size]
        while len(chans) - 1 < n_down:
            chans.append(cd * 16)
        self.chans = chans[: n_down + 1]
        for i in range(len(self.chans) - 1):
            self.add_module(f"conv{i}", SNConv(self.chans[i],
                                               self.chans[i + 1], 4, **kw))
        self.attn = SelfAttn(self.chans[2], **kw)
        self.fc = SNLinear(self.chans[-1], 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(len(self.chans) - 1):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x, stride=2), 0.1)
            if i == 1:
                x = self.attn(x)
        return self.fc(x.sum(dim=(2, 3)))


class _SNResMLPBlock(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.fc1 = SNLinear(channels, channels, **kw)
        self.fc2 = SNLinear(channels, channels, **kw)

    def forward(self, x):
        return F.relu(self.fc2(F.relu(self.fc1(x))) + x)


class DiscriminatorMLP(nn.Module):
    """Spectral-norm residual MLP discriminator; ``out_feature=True``
    returns (logit, penultimate features)."""

    def __init__(self, in_channels: int, out_channels: int,
                 out_feature: bool = True, num_block: int = 3, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.out_feature = out_feature
        self.num_block = num_block
        self.fc1 = SNLinear(in_channels, out_channels, **kw)
        for i in range(num_block):
            self.add_module(f"block{i + 1}",
                            _SNResMLPBlock(out_channels, **kw))
        self.fc4 = SNLinear(out_channels, 1, **kw)

    def forward(self, z: torch.Tensor):
        f = F.relu(self.fc1(z))
        for i in range(self.num_block):
            f = getattr(self, f"block{i + 1}")(f)
        out = self.fc4(f)
        return (out, f) if self.out_feature else out


class DCDiscriminator(nn.Module):
    """DCGAN-style discriminator: three plain 5x5 stride-2 ``"SAME"``
    convs (asymmetric pads on even inputs) with LeakyReLU 0.01, the NHWC
    flattening, a dense logit. The fc is sized from the post-conv spatial
    dims, as in the JAX package."""

    def __init__(self, conv_dim: int = 64, image_size: int = 64,
                 image_channel: int = 3, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if image_size % 8 != 0:
            raise ValueError("image_size must be divisible by 8")
        kw = dict(generator=generator, device=device)
        chans = [image_channel, conv_dim, conv_dim * 2, conv_dim * 4]
        for i in range(3):
            self.add_module(f"conv{i}", Conv2d(chans[i], chans[i + 1], 5,
                                               **kw))
        self.fc = Dense(conv_dim * 4 * (image_size // 8) ** 2, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x, stride=2), 0.01)
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
