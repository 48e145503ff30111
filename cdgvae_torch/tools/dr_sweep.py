"""DR hyperparameter study (port of ``scripts/dr_sweep.py``): can stronger
alignment keep the spurious background out of the causal latents?

At the reference's published DR hyperparameters (beta 0.1, lambda 20)
the background leaks into the angle latent and the worst-group accuracy
collapses (``docs/RESULTS.md``); the sweep varies only beta and lambda
of the reference protocol (100 epochs, batch 128, Adam 1e-3) over a
6-configuration grid.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.dr_sweep [--seeds 1] [--lams L ...]
        [--scm linear] [--repeats 10] [--detail] [--online] [--out FILE]
        [--device cuda] [--init torch|jax] [--first_seed 1]

Per seed: render the DR train split with normalised labels (training)
and the raw-label train and test splits (the downstream evals), each
through the render kernel's background path. Per configuration: train
the spurious 5-node CDG-VAE (``factory.build_pendulum_model(spurious=
True)``) on the fixed split, or with ``--online`` on a fresh batch every
step (``train/online.py::dr_batch_fn``) at the same step count; then
``eval/downstream.py::robustness`` (``--repeats`` fits of 500 epochs) and
the background-leak probe, each latent's |corr| with the background bit
on the test split. Writes the JAX script's list of records to ``--out``
(default ``cdgvae_torch/tools/results/dr_sweep<suffix>.json``), each
record with ``init`` and the ``device`` and ``card`` of
``tools/cdm_seeds.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.pendulum_dr import PendulumDRDataset
from ..eval.downstream import extract_representations, robustness
from ..train.loop import run_epochs
from ..train.online import dr_batch_fn, make_online_scanned_steps
from ..train.steps import make_optimizer, make_train_step
from ..utils.device import resolve_device
from .cdm_seeds import (RESULTS, add_port_flags, build_model, card_record,
                        write_json)

# the JAX script's fixed choices: the DR model, the protocol, the DGP's
# sample count and the robustness fit's epochs
CONFIG = dict(model="CDGVAE", node=5, scm="linear", flow_num=1,
              inverse_loop=100, factor=[1, 1, 2], image_size=64,
              adjacency_scaling=True, epochs=100, batch_size=128, lr=1e-3,
              n_samples=10000, robustness_epochs=500)
GRID = [(0.1, 20.0), (0.1, 40.0), (0.1, 80.0), (0.01, 20.0), (0.01, 80.0),
        (0.5, 20.0)]


def run_config(beta, lam, x, y, ds_tr, ds_te, config: dict = CONFIG, *,
               seed=1, online=False, repeats=10, detail=False,
               init: str = "torch") -> dict:
    """Train one (beta, lambda) configuration on ``x, y`` (or online) and
    score it; the JAX script's record. Its ``final_loss`` is, as there,
    the last epoch's mean loss, or online the last step's."""
    device = x.device
    model, _ = build_model(config, seed, init=init, spurious=True,
                           device=device)
    opt = make_optimizer(model, config["lr"])
    bs, epochs = config["batch_size"], config["epochs"]
    t0 = time.perf_counter()
    if online:
        # fresh data every step at the same step count; the evals below
        # stay on the fixed splits, so the numbers compare
        steps = len(x) // bs
        run = make_online_scanned_steps(
            model, opt, beta, lam, bs, steps,
            sample_batch=dr_batch_fn(bs, config["image_size"],
                                     norm_seed=seed,
                                     norm_n=config["n_samples"],
                                     device=device),
            seed=seed + 1000, device=device)
        for epoch in range(epochs):
            final_loss = run(epoch * steps)["loss"][-1].item()
    else:
        final_loss = run_epochs(make_train_step(model, opt, beta, lam), x,
                                y, seed=seed + 1000, epochs=epochs,
                                batch_size=bs)[-1]["loss"]
    dt = time.perf_counter() - t0
    y_tr, y_te = ds_tr.y_data.cpu().numpy(), ds_te.y_data.cpu().numpy()
    res = robustness(model, ds_tr.x_data, y_tr, ds_te.x_data, y_te, seed=0,
                     repeats=repeats, epochs=config["robustness_epochs"],
                     return_detail=detail)
    # leak probe: per-latent |corr| with the background on the test split
    reps = extract_representations(model, ds_te.x_data).cpu().numpy()
    bg = y_te[:, -2]
    leaks = [round(abs(float(np.corrcoef(reps[:, j], bg)[0, 1])), 2)
             for j in range(reps.shape[1])]
    return {"beta": beta, "lambda": lam, "epochs": epochs, "seed": seed,
            "scm": config["scm"], "online": online,
            "train_s": round(dt, 1),
            "final_loss": round(final_loss, 1),
            "avg_accuracy": round(res["avg_accuracy"], 4),
            "worst_group_accuracy": round(res["worst_group_accuracy"], 4),
            "bg_corr_per_latent": leaks,
            **({"per_repeat_avg": res["per_repeat_avg"],
                "per_repeat_worst": res["per_repeat_worst"]}
               if detail else {})}


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="",
                    help="default: cdgvae_torch/tools/results/"
                         "dr_sweep.json, suffixed _<scm> for non-linear "
                         "and _online for --online")
    ap.add_argument("--seeds", type=int, default=1,
                    help="repeat every config for seeds first_seed .. "
                         "(model init, train draws and dataset vary per "
                         "seed)")
    ap.add_argument("--lams", type=float, nargs="*", default=None,
                    help="restrict the sweep to these lambda values (beta "
                         "fixed 0.1); default: the full 6-config beta/"
                         "lambda grid")
    ap.add_argument("--scm", default="linear",
                    choices=["linear", "nonlinear"])
    ap.add_argument("--repeats", type=int, default=10,
                    help="downstream-classifier refits per config")
    ap.add_argument("--detail", action="store_true",
                    help="record per-repeat avg/worst-group accuracies")
    ap.add_argument("--online", action="store_true",
                    help="train with fresh data every step "
                         "(train/online.py) instead of the fixed dataset; "
                         "eval unchanged")
    add_port_flags(ap)
    args = ap.parse_args(argv)
    if not args.out:
        suffix = "" if args.scm == "linear" else f"_{args.scm}"
        suffix += "_online" if args.online else ""
        args.out = os.path.join(RESULTS, f"dr_sweep{suffix}.json")
    return args


def main(argv=None) -> list:
    args = get_args(argv)
    config = dict(CONFIG, scm=args.scm)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    record = {"init": args.init, **card_record(device)}
    grid = [(0.1, lam) for lam in args.lams] if args.lams else GRID
    size, n = config["image_size"], config["n_samples"]
    results = []
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        ds_tr, ds_te = (PendulumDRDataset(image_size=size, train=train,
                                          seed=seed, n=n, downstream=True,
                                          device=device)
                        for train in (True, False))
        # training labels: normalised (downstream=False)
        ds_align = PendulumDRDataset(image_size=size, train=True, seed=seed,
                                     n=n, device=device)
        for beta, lam in grid:
            r = run_config(beta, lam, ds_align.x_data, ds_align.y_data,
                           ds_tr, ds_te, config, seed=seed,
                           online=args.online, repeats=args.repeats,
                           detail=args.detail, init=args.init)
            r.update(record)
            print(json.dumps(r), flush=True)
            results.append(r)
    write_json(results, args.out)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
