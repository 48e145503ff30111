"""Tabular training entry point (port of ``cdgvae_tpu/cli/tabular_main.py:
25-161``, the same flags and defaults, plus ``--device``): VAE, InfoMax
and CDG-VAE on loan, adult and covtype.

Usage: python -m cdgvae_torch.cli.tabular_main --dataset loan --device cuda

Loads the dataset's train split (the CSV under ``--data_dir``, else the
schema-compatible synthetic table), trains for ``--epochs`` (the
fixed-shape epoch runner, last partial batch dropped; ``--eager`` keeps
it), prints one ``[epoch NNN]`` line per epoch, appends the metrics to
``<assets_dir>/metrics.jsonl`` and saves the checkpoint
``<assets_dir>/tabular_<model>_<dataset>`` (InfoMax's with the
discriminator and its Adam in ``extras``). ``--resume`` continues from a
checkpoint of either package. As in the reference, ``--node``,
``--factor`` and ``--input_dim`` are taken and then set from the
dataset's spec. ``--dp N`` trains on N ranks (``cli/common.py``),
InfoMax then with the ``"roll"`` marginal on each rank's batch. On a CUDA
device, without ``--eager`` or ``--dp``, the epochs replay one CUDA graph
a step (``cli/common.py::graphed_epochs``), equal to the eager runner bit
for bit.
"""
from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
import torch

from ..data.tabular.datasets import DATASET_SPECS, load_tabular
from ..factory import build_tabular_model
from ..parallel.mesh import is_main, rank_path, replicate
from ..train.loop import format_epoch, run_epochs, train_epoch
from ..train.scanned import NoisePlan
from ..train.steps import make_optimizer
from ..train.tabular_steps import (make_recon_fn, make_tabular_infomax_step,
                                   make_tabular_step)
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.interop import export_opt_state, export_params
from ..utils.logging import MetricLogger
from ..utils.profiling import trace
from ..utils.simulation import EPOCH, derived_generator, set_random_seed
from .common import (add_infra_args, add_resume_arg, apply_resume,
                     arg_as_bool, arg_as_list, graphed_epochs, train_on_mesh)


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--model", type=str, default="CDGVAE",
                        help="VAE, InfoMax, CDGVAE")
    parser.add_argument("--dataset", type=str, default="loan",
                        help="loan, adult, covtype")
    # declared, then set from DATASET_SPECS, as the reference does
    parser.add_argument("--node", default=3, type=int,
                        help="set from the dataset's spec")
    parser.add_argument("--factor", default=[1, 1, 1], type=arg_as_list,
                        help="set from the dataset's spec")
    parser.add_argument("--input_dim", default=5, type=int,
                        help="set from the dataset's spec")
    parser.add_argument("--scm", default="linear", type=str)
    parser.add_argument("--flow_num", default=1, type=int)
    parser.add_argument("--inverse_loop", default=100, type=int)
    parser.add_argument("--adjacency_scaling", default=True, type=arg_as_bool)
    parser.add_argument("--epochs", default=200, type=int)
    parser.add_argument("--batch_size", default=256, type=int)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--lr_D", default=0.001, type=float)
    parser.add_argument("--beta", default=0.01, type=float)
    parser.add_argument("--lambda", default=10, type=float)
    parser.add_argument("--gamma", default=1, type=float)
    parser.add_argument("--data_dir", default="./data", type=str,
                        help="directory with the real CSVs; synthetic "
                             "schema-compatible data is generated if absent")
    add_resume_arg(parser)
    add_infra_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    return train_on_mesh(train, vars(get_args(argv)))


def train(config: dict, mesh=None):
    """Train the tabular model of ``config`` (the parsed flags) and save
    it; under a ``mesh`` this is one rank of the run."""
    device = mesh.device if mesh is not None else resolve_device(
        config["device"])
    main_rank = is_main(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    set_random_seed(config["seed"])
    seed = config["seed"]
    spec = DATASET_SPECS[config["dataset"]]
    config["node"] = spec["node"]
    config["factor"] = list(spec["factor"])
    config["input_dim"] = spec["input_dim"]
    logger = MetricLogger(logdir=config["assets_dir"] if main_rank else None,
                          use_wandb=config["wandb"] and main_rank,
                          tags=["Tabular"], config=config)

    data = load_tabular(config["dataset"], train=True,
                        data_dir=config["data_dir"])
    x_data = torch.as_tensor(data.x_data, device=device)
    y_data = torch.as_tensor(data.label, device=device)

    model, discriminator = build_tabular_model(config, device=device,
                                               seed=seed)
    graphed = graphed_epochs(config, device, mesh)
    optimizer = make_optimizer(model, config["lr"], capturable=graphed)
    recon_fn = make_recon_fn(config["dataset"], data.flatten_topology)
    beta, lam = config["beta"], config["lambda"]
    infomax = config["model"] == "InfoMax"
    if infomax:
        optimizer_d = make_optimizer(discriminator, config["lr_D"],
                                     capturable=graphed)
        state = (model, discriminator, optimizer, optimizer_d)
        step = make_tabular_infomax_step(
            model, discriminator, optimizer, optimizer_d, beta, lam,
            config["gamma"], recon_fn,
            marginal="permutation" if mesh is None else "roll", mesh=mesh)
    else:
        state = (model, optimizer)
        step = make_tabular_step(model, optimizer, beta, lam, recon_fn,
                                 mesh)
    state, start_epoch = apply_resume(config, state, mesh=mesh)
    if mesh is not None:
        replicate(mesh, *state[:len(state) // 2])
    os.makedirs(config["assets_dir"], exist_ok=True)

    def on_epoch(epoch, metrics):
        if main_rank:
            print(format_epoch(epoch, metrics), flush=True)
            logger.log(metrics, step=epoch)

    with trace(config["profile"] if main_rank else ""):
        if config["eager"]:
            shuffle_rng = np.random.default_rng(seed + start_epoch)
            for epoch in range(start_epoch, config["epochs"]):
                on_epoch(epoch, train_epoch(
                    step, x_data, y_data, config["batch_size"],
                    derived_generator(seed, EPOCH, epoch, *rank_path(mesh),
                                      device=device),
                    shuffle_rng, mesh=mesh))
        else:
            run_epochs(step, x_data, y_data, seed=seed,
                       epochs=config["epochs"],
                       batch_size=config["batch_size"],
                       start_epoch=start_epoch, on_epoch=on_epoch,
                       mesh=mesh, graph_noise=partial(
                           NoisePlan, model, marginal="permutation"
                           if infomax else None) if graphed else None)
    if not main_rank:
        logger.finish()
        return state

    ckpt = os.path.join(config["assets_dir"],
                        f"tabular_{config['model']}_{config['dataset']}")
    extras = None
    if infomax:
        extras = {"d_params": export_params(discriminator),
                  "opt_state_d": export_opt_state(optimizer_d,
                                                  discriminator)}
    save_checkpoint(ckpt, export_params(model),
                    opt_state=export_opt_state(optimizer, model),
                    step=config["epochs"], config=config, extras=extras)
    print(f"checkpoint saved to {ckpt}")
    logger.finish()
    return state


if __name__ == "__main__":
    main()
