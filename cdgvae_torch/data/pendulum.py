"""Pendulum data-generating process + in-memory dataset.

Port of ``cdgvae_tpu/data/pendulum.py:37-168``. The DGP functions are numpy
and are kept here as the port's own copies. ``PendulumDataset`` renders its
images with ``ops.renderer.render`` on the dataset's device: on CUDA in one
launch of the hand-written kernel, on the CPU in chunks of 2048. With
``data_dir`` it loads a reference-format PNG tree instead
(``data/png_io.py``).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.renderer import CENTER, GROUND, ROD_LEN, render
from ..utils.device import resolve_device

FACTOR_NAMES = ["light", "angle", "length", "position", "target"]
_BETA = np.array([1.0, -1.0, 0.5, -0.5])


def shadow_physics(light_angle: np.ndarray, pendulum_angle: np.ndarray,
                   xp=np):
    """Closed-form shadow length/position; ``xp=torch`` for tensors."""
    cx, cy = CENTER
    l, b = ROD_LEN, GROUND
    tip_x = cx + l * xp.sin(pendulum_angle)
    tip_y = cy - l * xp.cos(pendulum_angle)
    t = xp.tan(light_angle)
    right = tip_x - (tip_y - b) / t
    left = cx - (cy - b) / t
    return right - left, (right + left) / 2.0


def shadow_draws(rng: np.random.RandomState, n: int):
    """The draws that the pendulum_real and DR DGPs share, in their order:
    (light, angle, length, position) of ``n`` rows, the shadow measured
    with error and every 5th row's resampled."""
    light = rng.uniform(math.pi / 4, math.pi / 2, n)
    angle = rng.uniform(0, math.pi / 4, n)
    length, position = shadow_physics(light, angle)

    scale = 0.1  # measurement-error scale
    length = length + rng.normal(0, scale, n)
    position = position + rng.normal(0, scale, n)

    # 20% corruption: every 5th sample's shadow resampled uniformly
    corrupt = (np.arange(n) + 1) % 5 == 0
    length = np.where(corrupt, rng.uniform(0, 12, n), length)
    position = np.where(corrupt, rng.uniform(0, 12, n), position)
    return light, angle, length, position


def sample_factors_real(seed: int = 1, n: int = 10000):
    """The pendulum_real DGP. Returns (factors [n,5], is_test [n]) where
    factor columns are (light, angle, length, position, target)."""
    rng = np.random.RandomState(seed)
    light, angle, length, position = shadow_draws(rng, n)
    logit = np.stack([light, angle, length, position], 1) @ _BETA
    p = 1.0 / (1.0 + np.exp(-logit + 2.0 * np.sin(logit)))
    target = rng.binomial(1, p).astype(np.float64)

    factors = np.stack([light, angle, length, position, target], axis=1)
    factors = np.round(factors, 4)  # 4-decimal filename rounding
    is_test = (np.arange(n) + 1) % 4 == 0  # 3:1 split
    return factors, is_test


def grid_factors(n_per_axis: int = 100):
    """Deterministic grid DGP. Returns (factors [n²,4], is_test). Outer
    loop = pendulum angle, inner = light."""
    light_list = np.linspace(math.pi / 4, math.pi / 2, n_per_axis)
    angle_list = np.linspace(0, math.pi / 4, n_per_axis)
    angle, light = np.meshgrid(angle_list, light_list, indexing="ij")
    light, angle = light.ravel(), angle.ravel()
    length, position = shadow_physics(light, angle)
    factors = np.round(np.stack([light, angle, length, position], 1), 4)
    is_test = (np.arange(light.size) + 1) % 4 == 0
    return factors, is_test


def normalize_labels(label: np.ndarray, label_normalization: bool = True):
    """Center then min-max to (0,1) per column. Returns (normalized,
    std_of_centered)."""
    label = label - label.mean(axis=0)
    std = label.std(axis=0)
    if label_normalization:
        label = (label - label.min(axis=0)) / (
            label.max(axis=0) - label.min(axis=0))
    return label, std


@dataclass
class PendulumDataset:
    """In-memory pendulum dataset rendered on ``device``.

    ``x_data``: [n, H, W, 3] float32 tensor in [-1, 1]; ``y_data``: [n, 5]
    float32 label tensor (light, angle, length, position, target); both on
    ``device``. ``factors`` keeps the raw numpy factors.
    ``labeled_ratio`` truncates the train split; ``downstream=True`` keeps
    raw labels. ``data_dir`` loads ``<data_dir>/{train,test}`` of a
    reference-format PNG tree (labels in the file names) instead of
    rendering the DGP; the labels are normalised over the loaded rows.
    """
    image_size: int = 64
    train: bool = True
    labeled_ratio: float = 1.0
    label_normalization: bool = True
    downstream: bool = False
    seed: int = 1
    n: int = 10000
    device: str | torch.device = "cuda"
    data_dir: str | None = None
    name: list = field(default_factory=lambda: list(FACTOR_NAMES))

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.data_dir is not None:
            self.x_data, factors = load_split(self)
        else:
            factors, is_test = sample_factors_real(self.seed, self.n)
            factors = factors[is_test if not self.train else ~is_test]
            if self.train and self.labeled_ratio < 1.0:
                factors = factors[: int(len(factors) * self.labeled_ratio)]
            self.x_data = _render_images(factors[:, :4], self.image_size,
                                         self.device)
        self.factors = factors
        label = factors.copy()
        if not self.downstream:
            label, self.std = normalize_labels(label,
                                               self.label_normalization)
        self.y_data = torch.as_tensor(label.astype(np.float32),
                                      device=self.device)

    def __len__(self):
        return len(self.x_data)


def load_split(ds) -> tuple[torch.Tensor, np.ndarray]:
    """(images on ``ds.device``, factors) of the dataset ``ds``'s split of
    the PNG tree ``ds.data_dir``, the train split cut to its first
    ``labeled_ratio`` share."""
    from .png_io import load_png_dataset

    x, factors = load_png_dataset(
        os.path.join(ds.data_dir, "train" if ds.train else "test"),
        ds.image_size, device=ds.device)
    if ds.train and ds.labeled_ratio < 1.0:
        keep = int(len(factors) * ds.labeled_ratio)
        x, factors = x[:keep], factors[:keep]
    return x, factors


def _render_images(factors: np.ndarray, image_size: int, device,
                   background: np.ndarray | None = None,
                   chunk: int = 2048) -> torch.Tensor:
    """Render every image of ``factors`` [n, 4] (and the DR family's
    ``background`` bits [n]) once on ``device``. The CUDA kernel needs no
    scratch, so the whole split is one launch that writes each image in
    place; the plain version on the CPU goes in chunks, which bound its
    temporaries."""
    f = torch.as_tensor(np.ascontiguousarray(factors), dtype=torch.float32,
                        device=device)
    bg = None if background is None else torch.as_tensor(
        np.ascontiguousarray(background), dtype=torch.float32, device=device)
    if f.device.type == "cuda":
        return render(f, size=image_size, background=bg)
    return torch.cat([render(c, size=image_size,
                             background=None if bg is None
                             else bg[i: i + chunk])
                      for i, c in zip(range(0, len(f), chunk),
                                      f.split(chunk))])
