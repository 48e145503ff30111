"""Multi-seed sample-efficiency study (port of ``scripts/se_seeds.py``):
the paper's Table 2 metric, acc(100 labels) / acc(all labels) of the
downstream classifier over 10 repeats, as mean ± std over fresh seeds at
the reference protocol (100 epochs, batch 128, Adam 1e-3, beta 0.1,
lambda 5).

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.se_seeds [--seeds 5] [--scm linear]
        [--epochs 100] [--n 10000] [--out FILE] [--device cuda]
        [--init torch|jax] [--first_seed 1]

Per seed: render the pendulum_real train split, train the CDG-VAE from
scratch through the fixed-dataset epoch runner, render the raw-label
train and test splits (``downstream=True``) and run
``eval/downstream.py::sample_efficiency`` (10 repeats). Writes the JAX
script's summary keys to ``--out`` (default
``cdgvae_torch/tools/results/se_seeds<suffix>.json``), plus
``loss_curves``, ``train_seconds`` and the ``init``, ``device`` and
``card`` of ``tools/cdm_seeds.py``, whose flags ``--device``, ``--init``
and ``--first_seed`` it shares.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.pendulum import PendulumDataset
from ..eval.downstream import sample_efficiency
from ..train.loop import run_epochs
from ..train.steps import make_optimizer, make_train_step
from ..utils.device import resolve_device
from .cdm_seeds import (CONFIG, RESULTS, add_port_flags, build_model,
                        card_record, log, write_json)


def run_seed(seed: int, config: dict = CONFIG, *, device="cuda",
             init: str = "torch") -> dict:
    """One seed: the JAX script's per-seed record (``accuracy_100``,
    ``accuracy_all``, ``sample_efficiency``) and, beside it,
    ``"loss_curve"`` and ``"train_seconds"``."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    size, n = config["image_size"], config["n_samples"]
    ds = PendulumDataset(image_size=size, train=True, seed=seed, n=n,
                         device=device)
    model, _ = build_model(config, seed, init=init, device=device)
    step = make_train_step(model, make_optimizer(model, config["lr"]),
                           config["beta"], config["lambda"])
    t0 = time.perf_counter()
    history = run_epochs(step, ds.x_data, ds.y_data, seed=seed + 1000,
                         epochs=config["epochs"],
                         batch_size=config["batch_size"])
    train_seconds = time.perf_counter() - t0
    curve = [h["loss"] for h in history]
    # the downstream protocol takes the raw labels for its target logit
    tr, te = (PendulumDataset(image_size=size, train=train, downstream=True,
                              seed=seed, n=n, device=device)
              for train in (True, False))
    res = sample_efficiency(model, tr.x_data, tr.y_data.cpu().numpy(),
                            te.x_data, te.y_data.cpu().numpy(), seed=seed,
                            repeats=10)
    log(f"seed {seed}: train {train_seconds:.0f}s, loss tail "
        f"{curve[-1]:.1f}, acc100 {res['accuracy_100']:.4f} accall "
        f"{res['accuracy_all']:.4f} SE {res['sample_efficiency']:.4f}")
    return {"record": res, "loss_curve": curve,
            "train_seconds": train_seconds}


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--scm", default="linear",
                    choices=["linear", "nonlinear"])
    ap.add_argument("--epochs", type=int, default=100,
                    help="reference protocol is 100; lower only for smoke")
    ap.add_argument("--n", type=int, default=10000,
                    help="DGP sample count (reference 10000)")
    ap.add_argument("--out", default="")
    add_port_flags(ap)
    args = ap.parse_args(argv)
    if not args.out:
        suffix = "" if args.scm == "linear" else f"_{args.scm}"
        args.out = os.path.join(RESULTS, f"se_seeds{suffix}.json")
    return args


def main(argv=None) -> dict:
    args = get_args(argv)
    config = dict(CONFIG, scm=args.scm, epochs=args.epochs, n_samples=args.n)
    device = resolve_device(args.device)
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    runs = [run_seed(s, config, device=device, init=args.init)
            for s in seeds]
    results = [r["record"] for r in runs]
    se = np.array([r["sample_efficiency"] for r in results])
    a100 = np.array([r["accuracy_100"] for r in results])
    aall = np.array([r["accuracy_all"] for r in results])
    summary = {
        "protocol": "reference main.py:93-107 train + "
                    "sample_efficiency.py 10-repeat downstream, "
                    "one full run per seed",
        "scm": args.scm,
        "seeds": seeds,
        "per_seed": results,
        "se_mean": round(float(se.mean()), 4),
        "se_std": round(float(se.std()), 4),
        "acc100_mean": round(float(a100.mean()), 4),
        "accall_mean": round(float(aall.mean()), 4),
        "loss_curves": [r["loss_curve"] for r in runs],
        "train_seconds": [r["train_seconds"] for r in runs],
        "init": args.init,
        **card_record(device),
    }
    write_json(summary, args.out)
    log(f"SE {summary['se_mean']} +/- {summary['se_std']} "
        f"(acc100 {summary['acc100_mean']}, accall "
        f"{summary['accall_mean']})")
    log(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
