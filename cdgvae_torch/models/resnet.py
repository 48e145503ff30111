"""ResNet-18/34/50 encoder (port of ``cdgvae_tpu/models/resnet.py``).

The trunk is initialised at random (no ImageNet weights offline) and is
frozen (``freeze_trunk=True``, the reference's configuration: it runs
without autograd and its parameters do not train) or trained end to end.
:meth:`ResNetEncoder.load_torch_weights` imports a torchvision-layout
state dict: OIHW kernels to HWIO, BatchNorm affine parameters and, by
default, the running statistics, which switch that BatchNorm to
eval-mode normalisation; the fc head is kept.

Parameter names and layouts are the JAX tree's: ``stem_conv.w`` (HWIO,
no bias), ``stem_bn.{scale, bias}`` (+ ``mean``/``var`` buffers after an
import), ``layer{l}_{b}.{conv1, bn1, conv2, bn2, [conv3, bn3], [down_conv,
down_bn]}``, ``fc.{w, b}``. Convs pad ``k // 2`` on each side (torch's
windows, not XLA's ``"SAME"``), and the 3x3/2 max-pool pads with -inf.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Dense, hwio_conv2d


class _Conv(nn.Module):
    """Bias-free conv, ``w`` HWIO, Kaiming normal over fan-out."""

    def __init__(self, in_ch: int, out_ch: int, k: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        std = math.sqrt(2.0 / (k * k * out_ch))
        w = torch.randn((k, k, in_ch, out_ch), generator=generator) * std
        self.w = nn.Parameter(w.to(device))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return hwio_conv2d(x, self.w, None, stride, self.w.shape[0] // 2)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, **kw):
        super().__init__()
        device = kw.get("device")
        self.conv1 = _Conv(in_ch, out_ch, 3, **kw)
        self.bn1 = BatchNorm(out_ch, device=device)
        self.conv2 = _Conv(out_ch, out_ch, 3, **kw)
        self.bn2 = BatchNorm(out_ch, device=device)
        self.has_down = in_ch != out_ch
        if self.has_down:
            self.down_conv = _Conv(in_ch, out_ch, 1, **kw)
            self.down_bn = BatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x, stride)))
        h = self.bn2(self.conv2(h))
        identity = self.down_bn(self.down_conv(x, stride)) \
            if self.has_down else x
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck: 1x1 reduce -> 3x3 (strided) -> 1x1 expand."""

    def __init__(self, in_ch: int, out_ch: int, **kw):
        super().__init__()
        device = kw.get("device")
        mid = out_ch // 4
        self.conv1 = _Conv(in_ch, mid, 1, **kw)
        self.bn1 = BatchNorm(mid, device=device)
        self.conv2 = _Conv(mid, mid, 3, **kw)
        self.bn2 = BatchNorm(mid, device=device)
        self.conv3 = _Conv(mid, out_ch, 1, **kw)
        self.bn3 = BatchNorm(out_ch, device=device)
        self.has_down = in_ch != out_ch
        if self.has_down:
            self.down_conv = _Conv(in_ch, out_ch, 1, **kw)
            self.down_bn = BatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h, stride)))
        h = self.bn3(self.conv3(h))
        identity = self.down_bn(self.down_conv(x, stride)) \
            if self.has_down else x
        return F.relu(h + identity)


_LAYERS = {"resnet18": [2, 2, 2, 2], "resnet34": [3, 4, 6, 3],
           "resnet50": [3, 4, 6, 3]}
_WIDTHS = [64, 128, 256, 512]
_BOTTLENECK = {"resnet18": False, "resnet34": False, "resnet50": True}


class ResNetEncoder(nn.Module):
    """ResNet trunk + linear head; images NCHW."""

    def __init__(self, out_dim: int, depth: str = "resnet18",
                 in_channels: int = 3, freeze_trunk: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.layers = _LAYERS[depth]
        self.bottleneck = _BOTTLENECK[depth]
        expansion = 4 if self.bottleneck else 1
        self.freeze_trunk = freeze_trunk
        self.stem_conv = _Conv(in_channels, 64, 7, **kw)
        self.stem_bn = BatchNorm(64, device=device)
        block = Bottleneck if self.bottleneck else BasicBlock
        in_ch = 64
        for li, (n, width) in enumerate(zip(self.layers, _WIDTHS)):
            for bi in range(n):
                self.add_module(f"layer{li}_{bi}",
                                block(in_ch, width * expansion, **kw))
                in_ch = width * expansion
        self.fc = Dense(512 * expansion, out_dim, **kw)
        if freeze_trunk:
            for name, p in self.named_parameters():
                if not name.startswith("fc."):
                    p.requires_grad_(False)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk's pooled features ([B, 512] for resnet18). A frozen
        trunk runs without autograd, as ``stop_gradient`` does."""
        ctx = torch.no_grad() if self.freeze_trunk \
            else contextlib.nullcontext()
        with ctx:
            h = F.relu(self.stem_bn(self.stem_conv(x, stride=2)))
            h = F.max_pool2d(h, 3, 2, padding=1)
            for li, n in enumerate(self.layers):
                for bi in range(n):
                    stride = 2 if (li > 0 and bi == 0) else 1
                    h = getattr(self, f"layer{li}_{bi}")(h, stride)
            return h.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))

    @torch.no_grad()
    def load_torch_weights(self, state_dict, use_running_stats: bool = True):
        """Import a torchvision-layout ResNet state dict (torch tensors or
        numpy arrays keyed ``conv1.weight``, ``bn1.*``,
        ``layer{1-4}.{i}.{conv,bn}{1-3}.*``, ``downsample.{0,1}.*``) in
        place: conv kernels OIHW -> HWIO, BatchNorm ``scale``/``bias`` and,
        with ``use_running_stats``, the running mean and variance, which
        switch each BatchNorm to eval-mode normalisation. The fc head is
        kept. Every shape is checked before anything is copied."""
        def arr(key):
            v = state_dict[key]
            return (v.detach().cpu().numpy() if hasattr(v, "detach")
                    else np.asarray(v)).astype(np.float32)

        copies = []  # (name, target tensor or BatchNorm, array(s))

        def conv(name, prefix):
            copies.append((name + ".w", self.get_submodule(name).w,
                           arr(prefix + ".weight").transpose(2, 3, 1, 0)))

        def bn(name, prefix):
            m = self.get_submodule(name)
            copies.append((name + ".scale", m.scale, arr(prefix + ".weight")))
            copies.append((name + ".bias", m.bias, arr(prefix + ".bias")))
            if use_running_stats:
                copies.append((name + ".mean", m, (
                    arr(prefix + ".running_mean"),
                    arr(prefix + ".running_var"))))

        conv("stem_conv", "conv1")
        bn("stem_bn", "bn1")
        n_inner = 3 if self.bottleneck else 2
        for li, n in enumerate(self.layers):
            for bi in range(n):
                src, dst = f"layer{li + 1}.{bi}", f"layer{li}_{bi}"
                for ci in range(1, n_inner + 1):
                    conv(f"{dst}.conv{ci}", f"{src}.conv{ci}")
                    bn(f"{dst}.bn{ci}", f"{src}.bn{ci}")
                if getattr(self, dst).has_down:
                    conv(f"{dst}.down_conv", f"{src}.downsample.0")
                    bn(f"{dst}.down_bn", f"{src}.downsample.1")
        for name, target, value in copies:
            if isinstance(target, BatchNorm):
                shapes = [v.shape for v in value]
                want = [tuple(target.scale.shape)] * 2
            else:
                shapes, want = [value.shape], [tuple(target.shape)]
            if [tuple(s) for s in shapes] != want:
                raise ValueError(f"shape mismatch at {name}: imported "
                                 f"{shapes[0]} vs {want[0]}")
        for _, target, value in copies:
            if isinstance(target, BatchNorm):
                target.set_running_stats(*value)
            else:
                target.copy_(torch.from_numpy(value))
        return self
