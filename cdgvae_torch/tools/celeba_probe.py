"""Linear-probe oracle of the frozen CelebA trunk (port of
``scripts/celeba_probe.py``: the same flags, protocol and output schema,
plus ``--device``).

Per-attribute logistic probes on the frozen trunk's pooled 512-d
features (``models/resnet.py::ResNetEncoder.features``, what the CelebA
model's fc head reads): an attribute the probe separates while the
CDG-VAE's alignment plateaus is an optimisation artifact of the joint
objective, not a ceiling of the features.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.celeba_probe [--n_train 256]
        [--n_test 64] [--img_size 128] [--data_seed 1] [--init_seed 1]
        [--torch_weights FILE] [--out FILE] [--device cuda]

Corpus: the studies' (``synthetic_celeba``, train seed ``data_seed``,
test seed ``data_seed + 1``), RGB channels. Trunks: the frozen-random
``ResNetEncoder(out_dim=24, freeze_trunk=True)`` drawn from
``torch.Generator().manual_seed(init_seed)`` (the JAX package's
architecture, not its init: ``jax.random``'s draws are its own), and the
same encoder after ``load_torch_weights`` of ``--torch_weights``
(``tools/celeba_pretrain.py``'s file, by default where that tool writes
it), probed when the file exists. Features are taken on the device in
batches of 64 (the random trunk's BatchNorm normalises with each batch's
statistics, as the script's does).

The probe (:func:`fit_logistic`) minimises scikit-learn's
``LogisticRegression(C=1e4, max_iter=5000)`` objective, 0.5 |w|^2 + C
times the summed log-loss with an unpenalised intercept, by L-BFGS in
float64 (scipy, imported inside the fit), to a tighter tolerance than
scikit-learn's default, so its objective is never above scikit-learn's.
Writes ``--out`` (default ``cdgvae_torch/tools/results/
celeba_probe.json``) in the script's schema, plus ``device`` and
``card``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.celeba import synthetic_celeba
from ..models.celeba import SMILE_NODES
from ..models.resnet import ResNetEncoder
from ..utils.device import resolve_device
from .cdm_seeds import RESULTS, card_record, write_json
from .celeba_pretrain import DEFAULT_OUT

C = 1e4
MAX_ITER = 5000


def features(encoder, x: np.ndarray, device, batch: int = 64) -> np.ndarray:
    """The trunk's pooled features of NHWC images ``x``, in batches."""
    out = []
    for i in range(0, len(x), batch):
        xb = torch.from_numpy(x[i: i + batch].transpose(0, 3, 1, 2).copy())
        out.append(encoder.features(xb.to(device)).cpu().numpy())
    return np.concatenate(out)


def objective(x: np.ndarray, y: np.ndarray, w: np.ndarray, b: float,
              c: float = C) -> float:
    """0.5 |w|^2 + c * sum(log(1 + exp(-s (x w + b)))), s = 2 y - 1."""
    x = np.asarray(x, np.float64)
    s = 2.0 * np.asarray(y, np.float64) - 1.0
    return float(0.5 * w @ w + c * np.logaddexp(0.0, -s * (x @ w + b)).sum())


def fit_logistic(x: np.ndarray, y: np.ndarray, c: float = C,
                 max_iter: int = MAX_ITER) -> tuple[np.ndarray, float]:
    """``(w, b)`` minimising :func:`objective` from zeros by L-BFGS-B in
    float64. The objective is minimised divided by ``c * n`` (the same
    minimiser, scikit-learn's scale), to a projected gradient of 1e-10."""
    from scipy.optimize import minimize

    x = np.asarray(x, np.float64)
    s = 2.0 * np.asarray(y, np.float64) - 1.0
    n, d = x.shape
    scale = 1.0 / (c * n)

    def f(theta):
        w, b = theta[:d], theta[d]
        m = -s * (x @ w + b)
        g = -s * np.exp(-np.logaddexp(0.0, -m))  # d loss / d (x w + b)
        value = 0.5 * w @ w + c * np.logaddexp(0.0, m).sum()
        grad = np.concatenate([w + c * (x.T @ g), [c * g.sum()]])
        return value * scale, grad * scale

    res = minimize(f, np.zeros(d + 1), jac=True, method="L-BFGS-B",
                   options={"maxiter": max_iter, "maxfun": 10 * max_iter,
                            "maxls": 50, "gtol": 1e-10, "ftol": 0.0})
    return res.x[:d], float(res.x[d])


def accuracy(x: np.ndarray, y: np.ndarray, w: np.ndarray, b: float) -> float:
    return float(((np.asarray(x, np.float64) @ w + b > 0) == (y > 0.5))
                 .mean())


def probe(feats_tr, y_tr, feats_te, y_te, nodes) -> dict:
    """Per-attribute logistic probes: each attribute's train and test
    accuracy, or a note where its train labels are all one class."""
    res = {}
    for j, name in enumerate(nodes):
        yj_tr, yj_te = y_tr[:, j], y_te[:, j]
        if len(np.unique(yj_tr)) < 2:
            res[name] = {"train_acc": None, "test_acc": None,
                         "note": "degenerate label"}
            continue
        w, b = fit_logistic(feats_tr, yj_tr)
        res[name] = {
            "train_acc": round(accuracy(feats_tr, yj_tr, w, b), 4),
            "test_acc": round(accuracy(feats_te, yj_te, w, b), 4),
        }
    accs = [v["test_acc"] for v in res.values() if v["test_acc"] is not None]
    res["_summary"] = {
        "mean_test_acc": round(float(np.mean(accs)), 4),
        "min_test_acc": round(float(np.min(accs)), 4),
        "n_separable_at_0.95": int(sum(a >= 0.95 for a in accs)),
    }
    return res


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_train", type=int, default=256,
                    help="match the λ-sweep protocol (256-image corpus)")
    ap.add_argument("--n_test", type=int, default=64)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--data_seed", type=int, default=1)
    ap.add_argument("--init_seed", type=int, default=1,
                    help="random-trunk init seed (studies trained seed 1)")
    ap.add_argument("--torch_weights", default=DEFAULT_OUT,
                    help="torchvision-layout resnet18 state dict "
                         "(tools/celeba_pretrain.py output)")
    ap.add_argument("--out", default=os.path.join(RESULTS,
                                                  "celeba_probe.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = get_args(argv)
    device = resolve_device(args.device)
    x_tr, y_tr = synthetic_celeba(args.n_train, args.img_size,
                                  seed=args.data_seed)
    x_te, y_te = synthetic_celeba(args.n_test, args.img_size,
                                  seed=args.data_seed + 1)
    x_tr, x_te = x_tr[..., :3], x_te[..., :3]

    def encoder():
        return ResNetEncoder(out_dim=24, freeze_trunk=True, device=device,
                             generator=torch.Generator().manual_seed(
                                 args.init_seed))

    results = {"protocol": {"n_train": args.n_train, "n_test": args.n_test,
                            "img_size": args.img_size,
                            "data_seed": args.data_seed,
                            "init_seed": args.init_seed,
                            "torch_weights": args.torch_weights},
               "nodes": list(SMILE_NODES)}
    trunks = {"random": encoder()}
    if args.torch_weights and os.path.exists(args.torch_weights):
        sd = torch.load(args.torch_weights, map_location="cpu")
        trunks["pretrained"] = encoder().load_torch_weights(sd)
    else:
        print(f"NOTE: no pretrained weights at {args.torch_weights} — "
              "probing the random trunk only")
    for name, enc in trunks.items():
        results[name] = probe(features(enc, x_tr, device), y_tr,
                              features(enc, x_te, device), y_te, SMILE_NODES)
        print(f"{name}: {results[name]['_summary']}")
    results.update(card_record(device))
    write_json(results, args.out)
    print(f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
