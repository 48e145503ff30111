"""Minimal NN core: dense, MLP and stacked (grouped) MLP layers, and the
conv and batch-statistics BatchNorm of the CelebA family.

Port of ``cdgvae_tpu/nn.py:27-160``. Parameters keep the JAX names and
layouts, so importing a JAX param pytree is a copy (``utils/interop.py``):
dense ``w`` is [in, out] and ``b`` is [out]; stacked ``w`` is [K, in, out]
and ``b`` is [K, 1, out]; a conv kernel ``w`` is HWIO [kh, kw, in, out].

The JAX convs run NHWC. Here activations are NCHW tensors, which the
CelebA models keep in ``channels_last`` memory (an NHWC image permuted to
NCHW is one already); the HWIO kernel is permuted to OIHW at the call.
Init follows torch ``nn.Linear``'s distribution
(uniform ±1/sqrt(fan_in) for weight and bias), drawn on the host from an
explicit ``torch.Generator`` so a seed gives the same weights on every
device, then moved to ``device``.

Under :func:`global_batch_stats` the batch-statistics BatchNorms
normalise with the statistics of the global batch over a mesh's ranks, as
the JAX package's GSPMD step computes them for a batch split over chips.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def uniform_param(shape, low: float, high: float,
                  generator: torch.Generator | None = None,
                  device=None) -> nn.Parameter:
    """U(low, high) float32 parameter, drawn on the host then moved."""
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(low, high, generator=generator)
    return nn.Parameter(t.to(device))


def dense(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w + b


def stacked_dense(w: torch.Tensor, b: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """x: [K, B, in] -> [K, B, out] via one batched matmul, in ``x``'s
    dtype: a bfloat16 ``w`` under a float32 ``x`` is cast up, as JAX's
    ``dot_general(..., preferred_element_type=x.dtype)`` promotes it (the
    CDG-VAE decoder under ``train/steps.py::cast_compute``)."""
    return torch.bmm(x, w.to(x.dtype)) + b


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.w = uniform_param((in_dim, out_dim), -bound, bound, generator,
                               device)
        self.b = uniform_param((out_dim,), -bound, bound, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.w, self.b, x)


class StackedDense(nn.Module):
    """K independent dense layers evaluated as one batched matmul."""

    def __init__(self, k: int, in_dim: int, out_dim: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.w = uniform_param((k, in_dim, out_dim), -bound, bound,
                               generator, device)
        self.b = uniform_param((k, 1, out_dim), -bound, bound, generator,
                               device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stacked_dense(self.w, self.b, x)


class MLP(nn.Module):
    """Stack of ``Dense`` layers ``layer0..layerN-1``; sizes = [in, ..., out].
    ELU between layers, optional final activation (``nn.py:55-65``)."""

    def __init__(self, sizes: Sequence[int], *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_layers = len(sizes) - 1
        for i in range(self.n_layers):
            self.add_module(f"layer{i}", Dense(sizes[i], sizes[i + 1],
                                               generator=generator,
                                               device=device))

    def forward(self, x: torch.Tensor, activation: Callable = F.elu,
                final_activation: Callable | None = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n_layers - 1:
                x = activation(x)
        if final_activation is not None:
            x = final_activation(x)
        return x


class StackedMLP(nn.Module):
    """K independent MLPs as one batched matmul per layer
    (``nn.py:96-112``); x: [K, B, in] -> [K, B, out]."""

    def __init__(self, k: int, sizes: Sequence[int], *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_layers = len(sizes) - 1
        for i in range(self.n_layers):
            self.add_module(f"layer{i}", StackedDense(
                k, sizes[i], sizes[i + 1], generator=generator,
                device=device))

    def forward(self, x: torch.Tensor,
                activation: Callable = F.elu) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n_layers - 1:
                x = activation(x)
        return x


# ---------------------------------------------------------------------------
# Conv (HWIO kernels, NCHW activations) and batch-statistics BatchNorm
# ---------------------------------------------------------------------------

def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: ``ceil(size /
    stride)`` outputs, the total pad split with the odd pixel at the end
    (a 5x5 stride-2 conv on an even input pads (1, 2))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def hwio_conv2d(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None, stride: int = 1,
                padding: str | int = "SAME") -> torch.Tensor:
    """``x`` [B, C, H, W] through the HWIO kernel ``w``; ``padding`` is
    ``"SAME"`` (XLA's, asymmetric where the total pad is odd) or a
    symmetric pixel count."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        top, bottom = same_pads(x.shape[2], kh, stride)
        left, right = same_pads(x.shape[3], kw, stride)
        if (top, left) == (bottom, right):
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride,
                    padding=padding)


class Conv2d(nn.Module):
    """Plain conv with bias (``nn.py:119-140``): ``w`` HWIO, ``b`` [out],
    both U(±1/sqrt(fan_in)), ``"SAME"`` padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * kernel * kernel)
        self.w = uniform_param((kernel, kernel, in_ch, out_ch), -bound,
                               bound, generator, device)
        self.b = uniform_param((out_ch,), -bound, bound, generator, device)

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return hwio_conv2d(x, self.w, self.b, stride)


# the mesh whose global batch the BatchNorms normalise over, or None
_stats_mesh = contextvars.ContextVar("stats_mesh", default=None)


@contextlib.contextmanager
def global_batch_stats(mesh):
    """Within the block, :func:`batchnorm` takes its mean and variance over
    the global batch of ``mesh``'s ranks (each rank holding an equal
    slice): two ``all_reduce``s a layer, which carry the gradient back to
    every rank. A ``None`` mesh changes nothing."""
    token = _stats_mesh.set(mesh)
    try:
        yield
    finally:
        _stats_mesh.reset(token)


def _global_batchnorm(x, scale, bias, eps, mesh):
    from torch.distributed.nn.functional import all_reduce

    count = x.numel() // x.shape[1] * mesh.size
    dims = (0, 2, 3)
    mean = all_reduce(x.sum(dim=dims, keepdim=True),
                      group=mesh.group) / count
    var = all_reduce(((x - mean) ** 2).sum(dim=dims, keepdim=True),
                     group=mesh.group) / count
    shape = (1, -1, 1, 1)
    return ((x - mean) * torch.rsqrt(var + eps) * scale.view(shape)
            + bias.view(shape))


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics BatchNorm over (N, H, W) of an NCHW tensor, biased
    variance, ``rsqrt(var + eps)``, in every mode (``nn.py:148-157``):
    no running averages are read or kept. Under :func:`global_batch_stats`
    the statistics are those of the mesh's global batch."""
    mesh = _stats_mesh.get()
    if mesh is not None:
        return _global_batchnorm(x, scale, bias, eps, mesh)
    if x.numel() > x.shape[1]:
        return F.batch_norm(x, None, None, scale, bias, training=True,
                            eps=eps)
    # one value a channel, which F.batch_norm refuses: variance 0
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    shape = (1, -1, 1, 1)
    return ((x - mean) * torch.rsqrt(var + eps) * scale.view(shape)
            + bias.view(shape))


class BatchNorm(nn.Module):
    """``{scale, bias}`` (ones and zeros) over ``ch`` channels, normalised
    with the batch's statistics. ``mean``/``var`` buffers, once set
    (``set_running_stats``: a torchvision import), switch it to eval-mode
    normalisation with those statistics."""

    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("mean", None)
        self.register_buffer("var", None)

    def set_running_stats(self, mean, var):
        """Store running statistics (copies), which the forward then
        normalises with."""
        device = self.scale.device
        self.mean = torch.as_tensor(mean, dtype=torch.float32).to(
            device).clone()
        self.var = torch.as_tensor(var, dtype=torch.float32).to(
            device).clone()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mean is None:
            return batchnorm(x, self.scale, self.bias)
        shape = (1, -1, 1, 1)
        return ((x - self.mean.view(shape))
                * torch.rsqrt(self.var.view(shape) + 1e-5)
                * self.scale.view(shape) + self.bias.view(shape))
