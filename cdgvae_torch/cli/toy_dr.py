"""Toy distributional-robustness experiment (port of ``cdgvae_tpu/cli/
toy_dr.py:23-113``, with ``--device`` in place of ``--platform``).

Usage: python -m cdgvae_torch.cli.toy_dr [--seed 0] [--n 10000]
       [--device cuda]

Compares three classifiers under a spurious-correlation shift: logistic
regression on the causal feature alone ("Disentangled"), on both features
("ERM"), and a trained 2 -> 1 -> 1 linear "Entangled" model, and prints
each one's train and test accuracy. The JAX package fits the logistic
regressions with scikit-learn; the port fits the same unpenalised,
intercept-free log-loss itself, by Newton's method in float64 (the loss
is convex, so both reach its one minimum). The entangled model trains on
the device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.losses import clipped_bce_probs
from ..train.steps import make_optimizer
from ..utils.device import resolve_device
from .common import add_device_arg


def generate(seed: int = 0, n: int = 10000, ratio: float = 0.9):
    """The toy DGP; ``ratio`` sets the spurious correlation's strength (0.9
    train, 0.5 test). Returns (x [n, 2], z [n, 2], y [n, 1] float32)."""
    rng = np.random.RandomState(seed)
    x1 = rng.normal(size=(n, 1))
    z1 = x1  # gamma = 1
    y = rng.binomial(1, 1.0 / (1.0 + np.exp(-2.0 * z1)))  # beta = 2

    x2 = np.zeros((n, 1))
    pos, neg = np.where(y == 1)[0], np.where(y == 0)[0]
    x2[pos[: int(ratio * len(pos))]] = 2
    x2[pos[int(ratio * len(pos)):]] = -2
    x2[neg[: int(ratio * len(neg))]] = -2
    x2[neg[int(ratio * len(neg)):]] = 2
    x2 = rng.normal(loc=x2)
    z2 = (x2 > 0).astype(float) + x2  # alpha = 1
    return (np.concatenate([x1, x2], 1), np.concatenate([z1, z2], 1),
            y.astype(np.float32))


def fit_logistic(X: np.ndarray, y: np.ndarray, tol: float = 1e-10,
                 max_iter: int = 100) -> np.ndarray:
    """Unpenalised logistic regression without intercept: the weights that
    minimise the mean log-loss, by Newton's method from zero. Raises if
    it does not converge (separable data has no minimum)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).ravel()
    w = np.zeros(X.shape[1])
    for _ in range(max_iter):
        p = 1.0 / (1.0 + np.exp(-(X @ w)))
        grad = X.T @ (p - y)
        hess = (X * (p * (1.0 - p))[:, None]).T @ X
        step = np.linalg.solve(hess, grad)
        w = w - step
        if np.max(np.abs(step)) <= tol * max(1.0, np.max(np.abs(w))):
            return w
    raise RuntimeError(f"logistic regression did not converge in "
                       f"{max_iter} Newton steps")


def logistic_acc(w, X, y) -> float:
    p = 1.0 / (1.0 + np.exp(-(X @ w)))
    return float(((p > 0.5).astype(float) == y.ravel()).mean())


def train_entangled(x, y, seed: int = 1, epochs: int = 20,
                    batch_size: int = 128, lr: float = 0.005, *,
                    device: str | torch.device = "cpu",
                    init: dict | None = None) -> dict:
    """2 -> 1 -> 1 linear sigmoid model without biases. The init, w1 ~
    N(0, 1/2) [2, 1] and w2 ~ N(0, 1) [1, 1], is drawn from a generator
    seeded ``seed`` (or given as ``init``, numpy); each epoch shuffles by
    a numpy permutation from ``default_rng(seed)`` and keeps the last
    short batch, as the reference. Returns {"w1", "w2"} tensors."""
    if init is None:
        g = torch.Generator().manual_seed(seed)
        init = {"w1": torch.randn((2, 1), generator=g) / np.sqrt(2),
                "w2": torch.randn((1, 1), generator=g)}
    params = {k: torch.nn.Parameter(torch.tensor(
        np.asarray(v, np.float32), device=device)) for k, v in init.items()}
    opt = make_optimizer(torch.nn.ParameterList(
        [params["w1"], params["w2"]]), lr)
    rng = np.random.default_rng(seed)
    x_dev = torch.as_tensor(np.asarray(x, np.float32), device=device)
    y_dev = torch.as_tensor(np.asarray(y, np.float32), device=device)
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(len(x)), device=device)
        for i in range(0, len(x), batch_size):
            idx = perm[i: i + batch_size]
            pred = torch.sigmoid(x_dev[idx] @ params["w1"] @ params["w2"])
            loss = clipped_bce_probs(pred, y_dev[idx]).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return {k: v.detach() for k, v in params.items()}


@torch.no_grad()
def entangled_acc(params, x, y) -> float:
    w1 = params["w1"]
    pred = torch.sigmoid(torch.as_tensor(np.asarray(x, np.float32),
                                         device=w1.device)
                         @ w1 @ params["w2"]).cpu().numpy()
    return float(((pred > 0.5).astype(float) == y).mean())


def main(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n", type=int, default=10000)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    x, z, y = generate(args.seed, args.n, ratio=0.9)
    tx, tz, ty = generate(args.seed + 1, args.n, ratio=0.5)

    results = {}
    w = fit_logistic(z[:, :1], y)
    results["Disentangled"] = (logistic_acc(w, z[:, :1], y),
                               logistic_acc(w, tz[:, :1], ty))
    w = fit_logistic(x, y)
    results["ERM"] = (logistic_acc(w, x, y), logistic_acc(w, tx, ty))
    p = train_entangled(x, y, seed=1, device=device)
    results["Entangled"] = (entangled_acc(p, x, y), entangled_acc(p, tx, ty))

    for name, (tr, te) in results.items():
        print(f"{name} model: train accuracy {tr * 100:.2f}%, "
              f"test accuracy {te * 100:.2f}%")
    return results


if __name__ == "__main__":
    main()
