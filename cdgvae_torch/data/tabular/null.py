"""Missing-value handling and the copula ``GaussianNormalizer`` (port of
``cdgvae_tpu/data/tabular/null.py``), numpy, with ``scipy.stats.norm``
imported inside the methods that use it.

* :class:`NullTransformer`: replace missing values (mean, mode or a
  constant), optionally emit an is-null indicator column, and put NaNs back
  on reverse at the fitted null rate.
* :class:`GaussianNormalizer`: rank-based Gaussian copula transform
  (empirical CDF, then the standard normal quantile), shipped for
  completeness as the reference ships it; its pipeline never uses it.
"""
from __future__ import annotations

import numpy as np

from .transformer import DataTransformer  # noqa: F401  (stack re-export)


class NullTransformer:
    """fit/transform/reverse_transform missing-value plumbing."""

    def __init__(self, missing_value_replacement: str | float = "mean",
                 model_missing_values: bool = False):
        self.missing_value_replacement = missing_value_replacement
        self.model_missing_values = model_missing_values

    def fit(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float64)
        isnull = np.isnan(data)
        self.null_rate = float(isnull.mean())
        if self.missing_value_replacement == "mean":
            self._fill = float(np.nanmean(data)) if (~isnull).any() else 0.0
        elif self.missing_value_replacement == "mode":
            vals, counts = np.unique(data[~isnull], return_counts=True)
            self._fill = float(vals[np.argmax(counts)]) if len(vals) else 0.0
        else:
            self._fill = float(self.missing_value_replacement)
        return self

    def models_missing_values(self) -> bool:
        return self.model_missing_values and self.null_rate > 0

    def transform(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.float64)
        isnull = np.isnan(data)
        filled = np.where(isnull, self._fill, data)
        if self.models_missing_values():
            return np.stack([filled, isnull.astype(np.float64)], axis=1)
        return filled

    def reverse_transform(self, data: np.ndarray,
                          rng: np.random.Generator | None = None
                          ) -> np.ndarray:
        data = np.asarray(data, dtype=np.float64)
        if self.models_missing_values():
            values, isnull = data[:, 0], data[:, 1] > 0.5
            return np.where(isnull, np.nan, values)
        if self.null_rate > 0:
            rng = rng or np.random.default_rng(0)
            mask = rng.uniform(size=len(data)) < self.null_rate
            return np.where(mask, np.nan, data)
        return data


class GaussianNormalizer:
    """Copula normalizer: empirical CDF -> N(0,1) quantiles and back."""

    def fit(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float64)
        data = data[~np.isnan(data)]
        self._sorted = np.sort(data)
        self._n = len(data)
        return self

    def transform(self, data: np.ndarray) -> np.ndarray:
        from scipy.stats import norm

        data = np.asarray(data, dtype=np.float64)
        ranks = np.searchsorted(self._sorted, data, side="right")
        u = np.clip(ranks / (self._n + 1), 1e-6, 1 - 1e-6)
        return norm.ppf(u)

    def reverse_transform(self, data: np.ndarray) -> np.ndarray:
        from scipy.stats import norm

        u = norm.cdf(np.asarray(data, dtype=np.float64))
        idx = np.clip((u * (self._n + 1)).astype(int) - 1, 0, self._n - 1)
        return self._sorted[idx]
