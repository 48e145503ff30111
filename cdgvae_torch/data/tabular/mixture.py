"""The variational Gaussian mixture behind ``ClusterBasedNormalizer``, in
numpy, for one column of data.

The JAX package fits scikit-learn's ``BayesianGaussianMixture(
n_components=min(n, 10), weight_concentration_prior_type=
"dirichlet_process", weight_concentration_prior=0.001, n_init=1,
random_state=s)``, every other argument at its default: full covariance,
k-means initialisation, ``max_iter=100``, ``tol=1e-3``, ``reg_covar=1e-6``.
The GPU machine has no scikit-learn, so this module copies what that fit
computes (scikit-learn 1.9.0, ``mixture/_base.py``, ``mixture/
_bayesian_mixture.py``, ``cluster/_kmeans.py`` and the Lloyd iteration of
``cluster/_k_means_lloyd.pyx``), with the same numpy operations on the
same shapes where the floats depend on them:

* k-means: X centred on its mean, k-means++ seeding (one ``choice``, then
  ``uniform(size=2 + int(log k))`` candidates a centre, the one that
  lowers the potential most kept), Lloyd iterations that stop when the
  labels repeat or the squared centre shift falls to ``1e-4`` times the
  column's variance, a final assignment when they stopped on the shift;
  empty clusters relocated to the farthest points as scikit-learn does;
* the mixture: responsibilities from the k-means labels, the
  stick-breaking weights, the Gaussian-Wishart means and covariances, E
  and M steps until the lower bound moves less than ``tol``.

One ``RandomState`` (from an int seed, as ``check_random_state`` makes it)
serves the k-means seeding and nothing else draws from it. ``scipy.special``
is imported inside the functions that need it.
"""
from __future__ import annotations

import math

import numpy as np

KMEANS_MAX_ITER, KMEANS_TOL = 300, 1e-4
# the mixture's settings (ClusterBasedNormalizer's and scikit-learn's
# defaults)
WEIGHT_CONCENTRATION_PRIOR, MAX_ITER, TOL, REG_COVAR = 0.001, 100, 1e-3, 1e-6


def _random_state(seed) -> np.random.RandomState:
    """``sklearn.utils.check_random_state``: None is numpy's global
    ``RandomState``, an int seeds a new one, an instance passes through."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def _row_norms(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", x, x)


def _sq_distances(a: np.ndarray, b: np.ndarray,
                  b_norms: np.ndarray) -> np.ndarray:
    """Squared euclidean distances [len(a), len(b)], as
    ``_euclidean_distances(a, b, Y_norm_squared=b_norms, squared=True)``
    sums them."""
    d = -2 * (a @ b.T)
    d += _row_norms(a)[:, None]
    d += b_norms.reshape(1, -1)
    np.maximum(d, 0, out=d)
    return d


def kmeans_plusplus(x: np.ndarray, k: int, x_norms: np.ndarray,
                    random_state: np.random.RandomState) -> np.ndarray:
    """k-means++ seeds [k, 1] of the centred data ``x`` [n, 1]: the first
    centre drawn uniformly, each next one the best of ``2 + int(log k)``
    candidates drawn in proportion to the squared distance."""
    n = x.shape[0]
    weight = np.ones(n)
    centers = np.empty((k, x.shape[1]))
    trials = 2 + int(np.log(k))
    first = random_state.choice(n, p=weight / weight.sum())
    centers[0] = x[first]
    closest = _sq_distances(centers[0, np.newaxis], x, x_norms)
    potential = closest @ weight
    for c in range(1, k):
        draws = random_state.uniform(size=trials) * potential
        candidates = np.searchsorted(np.cumsum(weight * closest), draws)
        np.clip(candidates, None, closest.size - 1, out=candidates)
        dist = _sq_distances(x[candidates], x, x_norms)
        np.minimum(closest, dist, out=dist)
        potentials = dist @ weight.reshape(-1, 1)
        best = np.argmin(potentials)
        potential = potentials[best]
        closest = dist[best]
        centers[c] = x[candidates[best]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Each row's nearest centre, the first on a tie: the argmin of
    ``||c||² - 2 x·c``, which is what the Lloyd step compares."""
    d = _row_norms(centers)[None, :] + -2.0 * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_iter(x: np.ndarray, centers: np.ndarray):
    """One Lloyd iteration: (labels, new centres, each centre's shift)."""
    k = centers.shape[0]
    labels = _assign(x, centers)
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.bincount(labels, weights=x[:, 0], minlength=k)
    empty = np.where(counts == 0)[0]
    if len(empty):
        # scikit-learn's _relocate_empty_clusters_dense: each empty cluster
        # takes one of the points farthest from their centres
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        if np.max(dist) != 0:
            far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= x[idx, 0] * 1.0
                sums[new] = x[idx, 0] * 1.0
                counts[new] = 1.0
                counts[old] -= 1.0
    # _average_centers, in its order: an empty cluster copies the heaviest
    # one as that one stands when the loop reaches it
    heaviest = np.argmax(counts)
    new_centers = sums[:, None].copy()
    for j in range(k):
        if counts[j] > 0:
            new_centers[j, 0] *= 1.0 / counts[j]
        else:
            new_centers[j, 0] = new_centers[heaviest, 0]
    shift = np.sqrt((new_centers[:, 0] - centers[:, 0]) *
                    (new_centers[:, 0] - centers[:, 0]))
    return labels, new_centers, shift


def kmeans_labels(x: np.ndarray, k: int,
                  random_state: np.random.RandomState) -> np.ndarray:
    """``KMeans(n_clusters=k, n_init=1, random_state=random_state).fit(x)
    .labels_`` for ``x`` [n, 1] float64."""
    x = np.array(x, dtype=np.float64, order="C")
    tol = np.mean(np.var(x, axis=0)) * KMEANS_TOL
    x -= x.mean(axis=0)
    centers = kmeans_plusplus(x, k, _row_norms(x), random_state)
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(KMEANS_MAX_ITER):
        labels, centers, shift = _lloyd_iter(x, centers)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    return labels


def _logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
    """scikit-learn's ``_logsumexp``: the maxima are taken out of the sum
    and counted, ``log1p(sum / count) + log(count) + max``."""
    a_max = np.max(a, axis=axis, keepdims=True)
    is_max = a == a_max
    a = a.copy()
    a[is_max] = -np.inf
    m = np.sum(is_max.astype(a.dtype), axis=axis, keepdims=True,
               dtype=a.dtype)
    shift = np.where(np.isfinite(a_max), a_max, 0)
    s = np.sum(np.exp(a - shift), axis=axis, keepdims=True, dtype=a.dtype)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + a_max, axis=axis)


def _gaussian_parameters(x: np.ndarray, resp: np.ndarray, reg_covar: float):
    """(nk [K], means [K, 1], covariances [K, 1, 1]) of the weighted
    data."""
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, np.newaxis]
    cov = np.empty((len(nk), 1, 1))
    for k in range(len(nk)):
        diff = x - means[k, :]
        cov[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        cov[k].flat[::2] += reg_covar
    return nk, means, cov


class BayesianGaussianMixture:
    """A Dirichlet-process variational Gaussian mixture of 1-D data, full
    covariance, k-means initialisation (see the module docstring).

    Fitted state: ``weights_`` [K], ``means_`` [K, 1], ``covariances_``
    [K, 1, 1], and the variational parameters ``weight_concentration_`` (a
    pair of [K]), ``mean_precision_`` and ``degrees_of_freedom_`` [K], from
    which ``predict_proba`` computes."""

    n_features = 1

    def __init__(self, n_components: int, random_state=None):
        self.n_components = n_components
        self.random_state = random_state

    @staticmethod
    def _column(x) -> np.ndarray:
        return np.asarray(x, dtype=np.float64).reshape(-1, 1)

    def fit(self, x):
        """Fit to ``x`` [n] or [n, 1]; n must be at least
        ``n_components`` and at least 2."""
        x = self._column(x)
        if x.shape[0] < max(2, self.n_components):
            raise ValueError(f"{x.shape[0]} samples for "
                             f"{self.n_components} components")
        self.mean_prior_ = x.mean(axis=0)
        self.covariance_prior_ = np.atleast_2d(np.cov(x.T))
        labels = kmeans_labels(x, self.n_components,
                               _random_state(self.random_state))
        resp = np.zeros((x.shape[0], self.n_components))
        resp[np.arange(x.shape[0]), labels] = 1
        self._m_step(x, resp)
        lower_bound = -np.inf
        self.converged_ = False
        for self.n_iter_ in range(1, MAX_ITER + 1):
            previous = lower_bound
            log_prob_norm, log_resp = self._log_prob_resp(x)
            self._m_step(x, np.exp(log_resp))
            lower_bound = self._lower_bound(log_resp)
            if abs(lower_bound - previous) < TOL:
                self.converged_ = True
                break
        self.lower_bound_ = lower_bound
        a, b = self.weight_concentration_
        total = a + b
        weights = a / total * np.hstack((1, np.cumprod((b / total)[:-1])))
        self.weights_ = weights / np.sum(weights)
        return self

    def _m_step(self, x: np.ndarray, resp: np.ndarray):
        nk, xk, sk = _gaussian_parameters(x, resp, REG_COVAR)
        self.weight_concentration_ = (
            1.0 + nk, WEIGHT_CONCENTRATION_PRIOR
            + np.hstack((np.cumsum(nk[::-1])[-2::-1], 0)))
        self.mean_precision_ = 1.0 + nk
        self.means_ = (1.0 * self.mean_prior_ + nk[:, np.newaxis] * xk) \
            / self.mean_precision_[:, np.newaxis]
        self.degrees_of_freedom_ = self.n_features + nk
        self.covariances_ = np.empty((self.n_components, 1, 1))
        for k in range(self.n_components):
            diff = xk[k] - self.mean_prior_
            self.covariances_[k] = (
                self.covariance_prior_ + nk[k] * sk[k]
                + nk[k] * 1.0 / self.mean_precision_[k]
                * np.outer(diff, diff))
        self.covariances_ /= self.degrees_of_freedom_[:, np.newaxis,
                                                      np.newaxis]

    def _precision_chol(self) -> np.ndarray:
        """[K]: the Cholesky factor of each 1x1 precision, 1 / sqrt(c)."""
        return 1.0 / np.sqrt(self.covariances_[:, 0, 0])

    def _log_prob_resp(self, x: np.ndarray):
        """(log p(x) [n], log responsibilities [n, K])."""
        from scipy.special import digamma

        n_features = self.n_features
        prec = self._precision_chol()
        log_prob = np.empty((x.shape[0], self.n_components))
        for k in range(self.n_components):
            p = prec[k].reshape(1, 1)
            y = (x @ p) - (self.means_[k, :] @ p)
            log_prob[:, k] = np.sum(np.square(y), axis=1)
        log_gauss = (-0.5 * (n_features * math.log(2 * math.pi) + log_prob)
                     + np.log(prec)
                     - 0.5 * n_features * np.log(self.degrees_of_freedom_))
        log_lambda = n_features * np.log(2.0) + np.sum(digamma(
            0.5 * (self.degrees_of_freedom_
                   - np.arange(0, n_features)[:, np.newaxis])), 0)
        a, b = self.weight_concentration_
        digamma_sum = digamma(a + b)
        log_weights = (digamma(a) - digamma_sum + np.hstack(
            (0, np.cumsum(digamma(b) - digamma_sum)[:-1])))
        weighted = (log_gauss + 0.5 * (log_lambda - n_features
                                       / self.mean_precision_)
                    + log_weights)
        log_prob_norm = _logsumexp(weighted, axis=1)
        with np.errstate(under="ignore"):
            log_resp = weighted - log_prob_norm[:, np.newaxis]
        return log_prob_norm, log_resp

    def _lower_bound(self, log_resp: np.ndarray) -> float:
        from scipy.special import betaln, gammaln

        n_features = self.n_features
        dof = self.degrees_of_freedom_
        log_det = (np.log(self._precision_chol())
                   - 0.5 * n_features * np.log(dof))
        log_wishart = np.sum(-(
            dof * log_det + dof * n_features * 0.5 * math.log(2.0)
            + np.sum(gammaln(0.5 * (dof - np.arange(n_features)[:, None])),
                     0)))
        log_norm_weight = -np.sum(betaln(*self.weight_concentration_))
        return (-np.sum(np.exp(log_resp) * log_resp) - log_wishart
                - log_norm_weight
                - 0.5 * n_features * np.sum(np.log(self.mean_precision_)))

    def predict_proba(self, x) -> np.ndarray:
        """Responsibilities [n, K] of ``x`` [n] or [n, 1]."""
        return np.exp(self._log_prob_resp(self._column(x))[1])
