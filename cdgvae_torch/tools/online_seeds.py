"""Multi-seed CDM study for online (fresh-data-per-step) training (port
of ``scripts/online_seeds.py``).

Every step draws a fresh batch from the pendulum_real DGP on the card
and renders it with the render kernel (``train/online.py``), at the
reference protocol's step count: 100 epochs of ``len(train split) //
128`` steps, Adam 1e-3, beta 0.1, lambda 5. The evaluation is the
fixed-dataset study's (``tools/cdm_seeds.py::score_cdm``): the CDM factor
classifier trains on the seed's fixed dataset, and the 4x4 CDM matrices
are computed on it.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.online_seeds [--seeds 5] [--scm linear]
        [--semi] [--out FILE] [--device cuda] [--init torch|jax]
        [--first_seed 1] [--eager]

``--semi`` trains on an infinite unlabeled stream with the alignment on
the seed's fixed 10%-labeled split (batch_sizeL 32). Writes the JAX
script's keys to ``--out`` (default
``cdgvae_torch/tools/results/online_seeds<suffix>.json``), plus
``loss_curves`` (the mean loss of each epoch's steps), ``train_seconds``
and the ``init``, ``device``, ``card`` and ``dispatch`` of
``tools/cdm_seeds.py``. On a CUDA device each step replays one CUDA graph
that holds the DGP's transform, the render kernel's launch and the step
(``train/online.py``, as ``cli.main --online`` trains), with a
``capturable`` Adam, and the CDM classifier trains graphed too;
``--eager`` keeps the eager trainer and the plain Adam.
"""
from __future__ import annotations

import argparse
import os
import time
from functools import partial

import numpy as np
import torch

from ..data.pendulum import PendulumDataset
from ..train.online import (make_online_run_from_loss,
                            make_online_scanned_steps, pendulum_batch_fn)
from ..train.scanned import Averager, NoisePlan
from ..train.steps import make_optimizer, make_semi_loss_fn
from ..utils.device import resolve_device
from .cdm_seeds import (CONFIG, PROTECTED, RESULTS, add_port_flags,
                        build_model, card_record, dispatch_record,
                        graphed_dispatch, log, param_digest, release_graphs,
                        score_cdm, write_json)


def run_seed(seed: int, config: dict = CONFIG, *, semi: bool = False,
             device="cuda", init: str = "torch", eager: bool | None = None,
             capturable: bool | None = None) -> dict:
    """One seed: ``{"lower", "upper"}`` (float64 [node, node]),
    ``"loss_curve"`` (each epoch's mean loss), ``"train_seconds"``,
    ``"cdm_seconds"`` and the trained model's ``"param_digest"``.
    ``eager`` and ``capturable`` are
    ``tools/cdm_seeds.py::run_seed``'s."""
    device = resolve_device(device)
    graphed, cap = graphed_dispatch(device, eager, capturable)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    size, n = config["image_size"], config["n_samples"]
    bs = config["batch_size"]
    ds = PendulumDataset(image_size=size, train=True, seed=seed, n=n,
                         device=device)
    model, _ = build_model(config, seed, init=init, device=device)
    opt = make_optimizer(model, config["lr"], capturable=cap)
    beta, lam = config["beta"], config["lambda"]
    steps_per_epoch = len(ds) // bs
    sample = pendulum_batch_fn(bs, size, norm_seed=seed, norm_n=n,
                               device=device)
    if semi:
        lab = PendulumDataset(image_size=size, train=True, seed=seed, n=n,
                              labeled_ratio=config["labeled_ratio"],
                              device=device)
        run = make_online_run_from_loss(
            make_semi_loss_fn(model, beta, lam), opt, sample,
            steps_per_epoch, seed=seed + 1000, device=device,
            labeled=(lab.x_data, lab.y_data),
            batch_size_l=min(config["batch_size_l"], len(lab)),
            graph_noise=partial(NoisePlan, model) if graphed else None)
    else:
        run = make_online_scanned_steps(
            model, opt, beta, lam, bs, steps_per_epoch, size,
            sample_batch=sample, seed=seed + 1000, device=device,
            graphed=graphed)
    t0 = time.perf_counter()
    curve = []
    for epoch in range(config["epochs"]):
        avg = Averager()
        avg.add(run(epoch * steps_per_epoch))
        curve.append(avg.result()["loss"])
    train_seconds = time.perf_counter() - t0
    lower, upper, cdm_seconds = score_cdm(model, ds.x_data, ds.y_data, seed,
                                          config, init=init, eager=eager,
                                          capturable=capturable)
    log(f"seed {seed}: online train {train_seconds:.1f}s (loss tail "
        f"{curve[-1]:.1f}), CDM {cdm_seconds:.1f}s, diag "
        f"{np.round(np.diag(upper), 3).tolist()}, protected max "
        f"{max(upper[i][j] for i, j in PROTECTED):.6f}")
    release_graphs()
    return {"lower": lower, "upper": upper, "loss_curve": curve,
            "train_seconds": train_seconds, "cdm_seconds": cdm_seconds,
            "param_digest": param_digest(model)}


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--scm", default="linear",
                    choices=["linear", "nonlinear"])
    ap.add_argument("--semi", action="store_true",
                    help="online semi-supervised protocol: an infinite "
                         "unlabeled stream and the seed's fixed 10%%-"
                         "labeled split (comparable to cdm_seeds --semi)")
    ap.add_argument("--out", default="")
    add_port_flags(ap)
    args = ap.parse_args(argv)
    if not args.out:
        suffix = "" if args.scm == "linear" else f"_{args.scm}"
        if args.semi:
            suffix += "_semi"
        args.out = os.path.join(RESULTS, f"online_seeds{suffix}.json")
    return args


def main(argv=None) -> dict:
    args = get_args(argv)
    config = dict(CONFIG, scm=args.scm)
    device = resolve_device(args.device)
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    eager = args.eager or None
    runs = [run_seed(s, config, semi=args.semi, device=device,
                     init=args.init, eager=eager) for s in seeds]
    lowers = np.stack([r["lower"] for r in runs])
    uppers = np.stack([r["upper"] for r in runs])
    protected_vals = np.array([uppers[:, i, j] for i, j in PROTECTED])
    out = {
        "config": {**config, "scm": args.scm, "online": True,
                   "semi": args.semi, "seeds": args.seeds,
                   "first_seed": args.first_seed},
        "lower_mean": lowers.mean(0).tolist(),
        "lower_std": lowers.std(0).tolist(),
        "upper_mean": uppers.mean(0).tolist(),
        "upper_std": uppers.std(0).tolist(),
        "upper_per_seed": uppers.tolist(),
        "protected_max": float(protected_vals.max()),
        "protected_all_zero": bool((protected_vals == 0).all()),
        "loss_curves": [r["loss_curve"] for r in runs],
        "train_seconds": [r["train_seconds"] for r in runs],
        "init": args.init,
        **card_record(device),
        **dispatch_record(device, eager),
    }
    write_json(out, args.out)
    log(f"wrote {args.out}")
    log("upper diag mean+/-std: " + str([
        f"{m:.3f}+/-{s:.3f}" for m, s in zip(np.diag(uppers.mean(0)),
                                             np.diag(uppers.std(0)))]))
    log(f"protected max {out['protected_max']:.6f} "
        f"(all-zero: {out['protected_all_zero']})")
    return out


if __name__ == "__main__":
    main()
