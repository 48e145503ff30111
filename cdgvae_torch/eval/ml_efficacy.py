"""ML efficacy: train on one table, test on the real one (port of
``cdgvae_tpu/eval/ml_efficacy.py:8-47``).

The reference fits three rows per task with scikit-learn: linear (or
logistic), random forest and gradient boosting. The port imports no
scikit-learn (the GPU machine has none), so it fits the first row, in
numpy, float64:

* ``linear``: least squares with an intercept (``LinearRegression``);
* ``logistic``: ``LogisticRegression``'s default, L2 with C = 1 on the
  weights (the intercepts unpenalised), multinomial over 3 or more
  classes, solved by Newton's method with a backtracking line search.

The ``RF`` and ``GradBoost`` rows are reported as skipped, by name, and
left out of the returned rows, so that a table scores the same on every
machine. Tables are float arrays with a list of column names.
Regression drops the target column by exact name, classification every
column whose name starts with it, as the reference does.
"""
from __future__ import annotations

import numpy as np


def _columns(columns, target: str, prefix: bool):
    keep = [k for k, c in enumerate(columns)
            if not (c.startswith(target) if prefix else c == target)]
    return keep, list(columns).index(target)


def fit_linear(x: np.ndarray, y: np.ndarray):
    """Least squares with an intercept on centred data, as
    ``LinearRegression`` solves it. Returns predict(x)."""
    x_mean, y_mean = x.mean(axis=0), y.mean()
    coef = np.linalg.lstsq(x - x_mean, y - y_mean, rcond=None)[0]
    intercept = y_mean - x_mean @ coef

    def predict(z):
        return z @ coef + intercept

    return predict


def _softmax_loss(theta, xb, onehot, c):
    """Multinomial log-loss summed over the rows plus ||W||² / (2C), its
    gradient and Hessian; ``theta`` [K, d+1], the last column the
    (unpenalised) intercepts, ``xb`` [n, d+1] with a column of ones."""
    z = xb @ theta.T
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    p = np.exp(logp)
    w = theta[:, :-1]
    loss = -(onehot * logp).sum() + 0.5 / c * (w * w).sum()
    grad = (p - onehot).T @ xb
    grad[:, :-1] += w / c
    k, m = theta.shape
    # blocks X^T diag(p_k [k == l] - p_k p_l) X, as one product
    px = (p[:, :, None] * xb[:, None, :]).reshape(len(xb), k * m)
    hess = -px.T @ px
    for j in range(k):
        hess[j * m:(j + 1) * m, j * m:(j + 1) * m] += xb.T @ px[:, j * m:
                                                                (j + 1) * m]
    hess[np.diag_indices(k * m)] += np.tile(
        np.r_[np.full(m - 1, 1.0 / c), 0.0], k)
    return loss, grad.ravel(), hess


def _logistic_loss(theta, xb, y, c):
    """Binary log-loss summed over the rows plus ||w||² / (2C), its
    gradient and Hessian; ``theta`` [d+1], the last entry the
    intercept."""
    z = xb @ theta
    loss = np.logaddexp(0.0, z).sum() - (y * z).sum()
    p = 1.0 / (1.0 + np.exp(-z))
    w = np.r_[theta[:-1], 0.0]
    loss += 0.5 / c * (w * w).sum()
    grad = xb.T @ (p - y) + w / c
    hess = (xb * (p * (1 - p))[:, None]).T @ xb
    hess[np.diag_indices(len(theta))] += np.r_[np.full(len(theta) - 1,
                                                       1.0 / c), 0.0]
    return loss, grad, hess


def fit_logistic(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                 max_iter: int = 100, tol: float = 1e-10):
    """``LogisticRegression(C=c)``'s optimum by Newton's method in float64.
    Returns predict(x) -> class labels."""
    classes = np.unique(y)
    xb = np.c_[x, np.ones(len(x))]
    if len(classes) == 2:
        target = (y == classes[1]).astype(np.float64)
        theta = np.zeros(xb.shape[1])
        objective = _logistic_loss
    else:
        target = (y[:, None] == classes[None]).astype(np.float64)
        theta = np.zeros((len(classes), xb.shape[1]))
        objective = _softmax_loss
    loss, grad, hess = objective(theta, xb, target, c)
    for _ in range(max_iter):
        # least squares: the multinomial intercepts have a free shift
        step = np.linalg.lstsq(hess, -grad, rcond=None)[0].reshape(
            theta.shape)
        t = 1.0
        while True:
            new = objective(theta + t * step, xb, target, c)
            if new[0] <= loss + 1e-4 * t * grad @ step.ravel() or t < 1e-8:
                break
            t /= 2
        theta = theta + t * step
        done = loss - new[0] <= tol * max(1.0, abs(loss))
        loss, grad, hess = new
        if done:
            break

    def predict(z):
        zb = np.c_[z, np.ones(len(z))]
        if theta.ndim == 1:
            return classes[(zb @ theta > 0).astype(int)]
        return classes[np.argmax(zb @ theta.T, axis=1)]

    return predict


def _skipped(names) -> None:
    for name in names:
        print(f"[{name}] skipped: the port fits no forest (it imports no "
              "scikit-learn)")


def regression_eval(train: np.ndarray, test: np.ndarray, columns,
                    target: str) -> list[tuple[str, float]]:
    """R² of each fitted row on ``test``, as (name, R²)."""
    keep, t = _columns(columns, target, prefix=False)
    xtr, ytr, xte, yte = train[:, keep], train[:, t], test[:, keep], \
        test[:, t]
    rows = [("linear", fit_linear(xtr, ytr))]
    _skipped(["RF", "GradBoost"])
    result = []
    for name, predict in rows:
        rsq = float(np.sum((yte - predict(xte)) ** 2))
        rsq /= np.var(yte) * len(test)
        rsq = 1.0 - rsq
        result.append((name, rsq))
        print(f"[{name}] R^2: {rsq:.3f}")
    return result


def classification_eval(train: np.ndarray, test: np.ndarray, columns,
                        target: str) -> list[tuple[str, float]]:
    """Micro-averaged F1 (the accuracy, one label a row) of each fitted
    row on ``test``, as (name, F1)."""
    keep, t = _columns(columns, target, prefix=True)
    xtr, ytr, xte, yte = train[:, keep], train[:, t], test[:, keep], \
        test[:, t]
    rows = [("logistic", fit_logistic(xtr, ytr))]
    _skipped(["RF", "GradBoost"])
    result = []
    for name, predict in rows:
        f1 = float(np.mean(predict(xte) == yte))
        result.append((name, f1))
        print(f"[{name}] F1: {f1:.3f}")
    return result
