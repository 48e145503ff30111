"""Pendulum-DR data-generating process: a spurious background attribute
(port of ``cdgvae_tpu/data/pendulum_dr.py:33-123``).

The pendulum physics, measurement error and 20% corruption of
pendulum_real, then the target tau ~ Bernoulli(sigmoid(logit - 2 sin
logit)) on the labels centred by the train mean, and the background bit
~ Bernoulli(0.8 if tau else 0.2) in the train split but 0.5/0.5 in the
test split: the distribution shift the robustness eval measures. A set
bit paints the axes window blue.

Label columns are [light, angle, length, position, background, target];
normalization touches the first four only. ``sample_factors_dr`` is the
port's own numpy copy; ``PendulumDRDataset`` renders on its device, on
CUDA in one launch of the render kernel with the background column, or
loads a reference-format PNG tree (``data_dir``, six file-name fields).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.device import resolve_device
from .pendulum import _BETA, _render_images, load_split, shadow_draws

DR_FACTOR_NAMES = ["light", "angle", "length", "position", "background",
                   "target"]


def sample_factors_dr(seed: int = 1, n: int = 10000):
    """Returns (train_factors [*, 6], test_factors [*, 6]); columns
    (light, angle, length, position, background, target)."""
    rng = np.random.RandomState(seed)
    factors = np.round(np.stack(shadow_draws(rng, n), 1), 4)
    is_test = (np.arange(n) + 1) % 4 == 0
    train_f, test_f = factors[~is_test], factors[is_test]

    # the target logit is taken on labels centred by the TRAIN mean
    mean = train_f.mean(axis=0)

    def tau_and_background(f, p1, p0):
        logit = (f - mean) @ _BETA
        tau = rng.binomial(1, 1.0 / (1.0 + np.exp(-logit
                                                  + 2.0 * np.sin(logit))))
        p = np.where(tau == 1, p1, p0)
        background = (rng.uniform(size=len(f)) < p).astype(np.float64)
        return tau.astype(np.float64), background

    tr_tau, tr_bg = tau_and_background(train_f, 0.8, 0.2)
    te_tau, te_bg = tau_and_background(test_f, 0.5, 0.5)

    train = np.concatenate([train_f, tr_bg[:, None], tr_tau[:, None]], 1)
    test = np.concatenate([test_f, te_bg[:, None], te_tau[:, None]], 1)
    return train, test


@dataclass
class PendulumDRDataset:
    """DR dataset rendered on ``device``.

    ``x_data``: [n, H, W, 3] float32 tensor in [-1, 1], blue window where
    the background bit is set; ``y_data``: [n, 6] float32 labels; both on
    ``device``. ``factors`` keeps the raw numpy factors. ``labeled_ratio``
    truncates the train split; ``downstream=True`` keeps raw labels.
    ``data_dir`` loads a split of a reference-format PNG tree instead.
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
    name: list = field(default_factory=lambda: list(DR_FACTOR_NAMES))

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.data_dir is not None:
            self.x_data, factors = load_split(self)
        else:
            train_f, test_f = sample_factors_dr(self.seed, self.n)
            factors = train_f if self.train else test_f
            if self.train and self.labeled_ratio < 1.0:
                factors = factors[: int(len(factors) * self.labeled_ratio)]
            self.x_data = _render_images(factors[:, :4], self.image_size,
                                         self.device,
                                         background=factors[:, 4])
        self.factors = factors
        label = factors.copy()
        if not self.downstream:
            label[:, :4] = label[:, :4] - label[:, :4].mean(axis=0)
            self.std = label.std(axis=0)
            if self.label_normalization:
                label[:, :4] = (label[:, :4] - label[:, :4].min(axis=0)) / (
                    label[:, :4].max(axis=0) - label[:, :4].min(axis=0))
        self.y_data = torch.as_tensor(label.astype(np.float32),
                                      device=self.device)

    def __len__(self):
        return len(self.x_data)
