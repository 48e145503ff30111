"""Minimal NN core: dense, MLP and stacked (grouped) MLP layers.

Port of ``cdgvae_tpu/nn.py:27-112``. Parameters keep the JAX names and
layouts, so importing a JAX param pytree is a copy (``utils/interop.py``):
dense ``w`` is [in, out] and ``b`` is [out]; stacked ``w`` is [K, in, out]
and ``b`` is [K, 1, out]. Init follows torch ``nn.Linear``'s distribution
(uniform ±1/sqrt(fan_in) for weight and bias), drawn on the host from an
explicit ``torch.Generator`` so a seed gives the same weights on every
device, then moved to ``device``.
"""
from __future__ import annotations

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
    """x: [K, B, in] -> [K, B, out] via one batched matmul."""
    return torch.bmm(x, w) + b


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
