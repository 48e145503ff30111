"""Multi-seed CDM study (port of ``scripts/cdm_seeds.py``): CDM as mean ±
std over repeated runs, as the paper reports it (appendix Tables 10-11),
at the reference protocol (100 epochs, batch 128, Adam 1e-3, beta 0.1,
lambda 5).

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.cdm_seeds [--seeds 5] [--scm linear]
        [--semi] [--model CDGVAE|VAE|InfoMax] [--gamma 1] [--free_bits 0]
        [--out FILE] [--device cuda]

Per seed: render the pendulum_real train split (``PendulumDataset``, one
render launch), train the model from scratch through the fixed-dataset
epoch runner, train the CDM factor classifier (50 epochs, the masks of
``cli/main_classifier.py``), and compute the 4x4 CDM matrices
(``eval/metric.py::cdm_matrices``). Writes the JAX script's summary keys
to ``--out`` (default ``cdgvae_torch/tools/results/cdm_seeds<suffix>.json``,
the suffix as the JAX script names it), plus ``loss_curves`` (each seed's
per-epoch mean loss), ``train_seconds`` and ``device``.

The runs cannot equal the JAX runs: the port draws its init and its noise
from torch generators (the same distributions). :func:`run_seed` takes the
protocol as a config, so that a test or ``chip_smoke.py`` can run it cut.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..cli.main_classifier import classifier_masks
from ..data.pendulum import PendulumDataset
from ..eval.metric import cdm_matrices
from ..factory import build_pendulum_model
from ..models.classifier import FactorClassifier
from ..ops.losses import alignment_bce
from ..train.loop import run_epochs, run_epochs_semi
from ..train.steps import (make_infomax_step, make_optimizer,
                           make_semi_step, make_train_step, step_from_loss)
from ..utils.device import resolve_device

CONFIG = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
              inverse_loop=100, factor=[1, 1, 2], image_size=64,
              adjacency_scaling=True, epochs=100, batch_size=128,
              lr=0.001, beta=0.1, **{"lambda": 5.0},
              # the JAX script's fixed choices: the DGP's sample count,
              # the classifier's epochs, cli.main's InfoMax lr_D and
              # main_semi's labeled stream
              n_samples=10000, classifier_epochs=50, lr_D=1e-4,
              labeled_ratio=0.1, batch_size_l=32)

# cells with no causal path source->checked: light and angle are roots
# whose descendants are length and position; the masked GAM decoder holds
# CDM at exactly 0 on these (paper Table 10)
PROTECTED = [(0, 1), (1, 0), (2, 0), (2, 1), (3, 0), (3, 1)]

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results")


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def run_seed(seed: int, config: dict = CONFIG, *, semi: bool = False,
             gamma: float = 1.0, free_bits: float = 0.0,
             device="cuda") -> dict:
    """One seed of the study under ``config`` (:data:`CONFIG`'s keys;
    ``config["model"]`` and ``config["scm"]`` pick the model). Returns
    ``{"lower", "upper"}`` (float64 [node, node]), ``"loss_curve"`` (each
    epoch's mean loss), ``"train_seconds"`` and ``"cdm_seconds"``."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    ds = PendulumDataset(image_size=config["image_size"], train=True,
                         seed=seed, n=config["n_samples"], device=device)
    model, disc = build_pendulum_model(config, device=device, seed=seed)
    opt = make_optimizer(model, config["lr"])
    beta, lam, bs = config["beta"], config["lambda"], config["batch_size"]
    t0 = time.perf_counter()
    if config["model"] == "InfoMax":
        step = make_infomax_step(model, disc, opt,
                                 make_optimizer(disc, config["lr_D"]), beta,
                                 lam, gamma)
    elif semi:
        lab = PendulumDataset(image_size=config["image_size"], train=True,
                              seed=seed, n=config["n_samples"],
                              labeled_ratio=config["labeled_ratio"],
                              device=device)
        history = run_epochs_semi(
            make_semi_step(model, opt, beta, lam), ds.x_data, lab.x_data,
            lab.y_data, seed=seed + 1000, epochs=config["epochs"],
            batch_size=bs, batch_size_l=config["batch_size_l"])
    else:
        step = make_train_step(model, opt, beta, lam, free_bits=free_bits)
    if not semi:
        history = run_epochs(step, ds.x_data, ds.y_data, seed=seed + 1000,
                             epochs=config["epochs"], batch_size=bs)
    train_seconds = time.perf_counter() - t0
    curve = [h["loss"] for h in history]

    node = config["node"]
    clf = FactorClassifier(classifier_masks(config["image_size"], node),
                           node, config["image_size"],
                           generator=torch.Generator().manual_seed(
                               seed + 2000), device=device)

    def clf_loss(x, y, generator=None):  # deterministic: no draws
        loss = alignment_bce(clf(x), y[:, :node])
        return loss, {"loss": loss}

    run_epochs(step_from_loss(clf_loss, make_optimizer(clf, 1e-3)),
               ds.x_data, ds.y_data, seed=seed + 3000,
               epochs=config["classifier_epochs"], batch_size=bs)

    t0 = time.perf_counter()
    with torch.no_grad():
        lower, upper = cdm_matrices(model, clf, ds.x_data, batch_size=1024)
    cdm_seconds = time.perf_counter() - t0
    log(f"seed {seed}: train {train_seconds:.1f}s (loss tail "
        f"{curve[-1]:.1f}), CDM {cdm_seconds:.1f}s, diag "
        f"{np.round(np.diag(upper), 3).tolist()}, protected max "
        f"{max(upper[i][j] for i, j in PROTECTED):.6f}")
    return {"lower": np.asarray(lower), "upper": np.asarray(upper),
            "loss_curve": curve, "train_seconds": train_seconds,
            "cdm_seconds": cdm_seconds}


def summarize(runs: list, *, seeds: list, scm: str, semi: bool,
              model: str, free_bits: float, device: str) -> dict:
    """The JAX script's summary of ``runs`` (:func:`run_seed`'s results),
    with each seed's loss curve and train seconds."""
    lowers = np.stack([r["lower"] for r in runs])
    uppers = np.stack([r["upper"] for r in runs])
    prot = np.array([[u[i][j] for i, j in PROTECTED] for u in uppers])
    node = uppers.shape[1]
    return {
        "protocol": "reference main.py:93-107 (100 epochs, batch 128, "
                    "lr 1e-3, beta 0.1, lambda 5), one run per seed",
        "scm": scm,
        "semi": semi,
        "model": model,
        "free_bits": free_bits,
        "protected_mean": np.abs(prot).mean(0).round(4).tolist(),
        "protected_std": np.abs(prot).std(0).round(4).tolist(),
        "seeds": list(seeds),
        "lower": lowers.tolist(),
        "upper": uppers.tolist(),
        "diag_upper_mean": np.diag(uppers.mean(0)).round(4).tolist(),
        "diag_upper_std": uppers.std(0)[np.arange(node), np.arange(node)]
                                .round(4).tolist(),
        "protected_max_abs": float(np.abs(prot).max()),
        "loss_curves": [r["loss_curve"] for r in runs],
        "train_seconds": [r["train_seconds"] for r in runs],
        "device": device,
    }


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--scm", default="linear",
                    choices=["linear", "nonlinear"])
    ap.add_argument("--semi", action="store_true",
                    help="semi-supervised protocol (main_semi: "
                         "labeled_ratio 0.1, batch_sizeL 32)")
    ap.add_argument("--model", default="CDGVAE",
                    choices=["CDGVAE", "VAE", "InfoMax"],
                    help="baseline rows of appendix Tables 10-11")
    ap.add_argument("--gamma", type=float, default=1.0,
                    help="InfoMax MI weight")
    ap.add_argument("--free_bits", type=float, default=0.0,
                    help="per-dim KL floor in nats (supervised CDGVAE "
                         "protocol only); 0 = the reference objective")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.free_bits and (args.semi or args.model != "CDGVAE"):
        ap.error("--free_bits A/B targets the supervised CDGVAE protocol")
    if args.semi and args.model != "CDGVAE":
        ap.error("the reference's semi-supervised protocol is CDGVAE-only")
    if not args.out:
        suffix = "" if args.model == "CDGVAE" else f"_{args.model.lower()}"
        suffix += "" if args.scm == "linear" else f"_{args.scm}"
        if args.semi:
            suffix += "_semi"
        if args.free_bits:
            suffix += "_freebits"
        args.out = os.path.join(RESULTS, f"cdm_seeds{suffix}.json")
    return args


def main(argv=None) -> dict:
    args = get_args(argv)
    config = dict(CONFIG, scm=args.scm, model=args.model)
    seeds = list(range(1, args.seeds + 1))
    runs = [run_seed(seed, config, semi=args.semi, gamma=args.gamma,
                     free_bits=args.free_bits, device=args.device)
            for seed in seeds]
    device = resolve_device(args.device)
    summary = summarize(runs, seeds=seeds, scm=args.scm, semi=args.semi,
                        model=args.model, free_bits=args.free_bits,
                        device=torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    log(f"upper diag mean {summary['diag_upper_mean']} "
        f"std {summary['diag_upper_std']}")
    log(f"protected cells max |CDM| over all seeds: "
        f"{summary['protected_max_abs']}")
    log(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
