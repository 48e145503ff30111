"""CDG-TVAE training entry point (port of ``cdgvae_tpu/cli/
tabular_main_tvae.py``, the same flags and defaults, plus ``--device``):
the tabular VAE over DataTransformer encodings, on loan, adult and
covtype.

Usage: python -m cdgvae_torch.cli.tabular_main_tvae --dataset loan
       [--device cuda]

Fits the DataTransformer on the dataset's train rows (the CSV under
``--data_dir``, else the synthetic table; the transformer's random state
per dataset as the reference sets it), sets ``input_dim`` and the
decoder blocks' widths from its spans, and trains with Adam and L2 weight
decay (the fixed-shape epoch runner, last partial batch dropped;
``--eager`` keeps it), clamping ``sigma`` into ``--sigma_range`` after
every step. Prints one ``[epoch NNN]`` line per epoch, appends the
metrics to ``<assets_dir>/metrics.jsonl`` and saves
``<assets_dir>/tabular_TVAE_<dataset>/`` with ``state.pkl``,
``config.json`` and ``transformer.npz`` (the fitted transformer, which
data-space serving and ``cli.tabular_inference_tvae`` read). ``--resume``
continues from a checkpoint of either package: the transformer is fitted
again from the data, as deterministically as the first time. As in the
reference, ``--node`` and ``--factor`` are taken and then set from the
dataset's spec. ``--dp N`` trains on N ranks (``cli/common.py``), the
sigma clamp after every step on each. On a CUDA device, without
``--eager`` or ``--dp``, the epochs replay one CUDA graph a step, the
clamp captured in it (``cli/common.py::graphed_epochs``), equal to the
eager runner bit for bit.
"""
from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
import torch

from ..data.tabular.datasets import DATASET_SPECS, load_tabular_tvae
from ..factory import build_tabular_model, tvae_block_mask
from ..parallel.mesh import is_main, rank_path, replicate
from ..train.loop import format_epoch, run_epochs, train_epoch
from ..train.scanned import NoisePlan
from ..train.steps import make_optimizer
from ..train.tabular_steps import make_sigma_clamp, make_tvae_step
from ..utils.checkpoint import atomic_write, save_checkpoint
from ..utils.device import resolve_device
from ..utils.interop import export_opt_state, export_params
from ..utils.logging import MetricLogger
from ..utils.profiling import trace
from ..utils.simulation import EPOCH, derived_generator, set_random_seed
from .common import (add_infra_args, add_resume_arg, apply_resume,
                     arg_as_bool, arg_as_list, graphed_epochs, train_on_mesh)

# the transformer's random state per dataset, as the reference sets it
TRANSFORMER_RANDOM_STATE = {"loan": 8, "adult": 0, "covtype": 0}


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--model", type=str, default="TVAE")
    parser.add_argument("--dataset", type=str, default="loan",
                        help="loan, adult, covtype")
    # declared, then set from DATASET_SPECS, as the reference does
    parser.add_argument("--node", default=3, type=int,
                        help="set from the dataset's spec")
    parser.add_argument("--factor", default=[1, 1, 1], type=arg_as_list,
                        help="set from the dataset's spec")
    parser.add_argument("--scm", default="linear", type=str)
    parser.add_argument("--flow_num", default=1, type=int)
    parser.add_argument("--inverse_loop", default=100, type=int)
    parser.add_argument("--adjacency_scaling", default=True, type=arg_as_bool)
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--batch_size", default=256, type=int)
    parser.add_argument("--lr", default=0.001, type=float)
    parser.add_argument("--weight_decay", default=1e-5, type=float)
    parser.add_argument("--lambda", default=5, type=float)
    parser.add_argument("--sigma_range", default=[0.01, 0.1],
                        type=arg_as_list)
    parser.add_argument("--data_dir", default="./data", type=str)
    add_resume_arg(parser)
    add_infra_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    return train_on_mesh(train, vars(get_args(argv)))


def train(config: dict, mesh=None):
    """Fit the transformer, train the TVAE of ``config`` (the parsed
    flags) and save both; under a ``mesh`` this is one rank of the run."""
    device = mesh.device if mesh is not None else resolve_device(
        config["device"])
    main_rank = is_main(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    set_random_seed(config["seed"])
    seed, dataset = config["seed"], config["dataset"]
    spec = DATASET_SPECS[dataset]
    config["node"] = spec["node"]
    config["factor"] = list(spec["factor"])

    data = load_tabular_tvae(dataset, data_dir=config["data_dir"],
                             random_state=TRANSFORMER_RANDOM_STATE[dataset])
    spans = data.transformer.output_info_list
    config["input_dim"] = data.transformer.output_dimensions
    config["tvae_mask"] = tvae_block_mask(dataset, spans)
    logger = MetricLogger(logdir=config["assets_dir"] if main_rank else None,
                          use_wandb=config["wandb"] and main_rank,
                          tags=["Tabular", "TVAE"], config=config)
    x_data = torch.as_tensor(data.x_data, device=device)
    y_data = torch.as_tensor(data.label, device=device)

    model, _ = build_tabular_model(config, device=device, seed=seed)
    graphed = graphed_epochs(config, device, mesh)
    optimizer = make_optimizer(model, config["lr"], capturable=graphed,
                               weight_decay=config["weight_decay"])
    step = make_tvae_step(model, optimizer, config["lambda"], spans, mesh)
    clamp = make_sigma_clamp(model, tuple(config["sigma_range"]))
    (model, optimizer), start_epoch = apply_resume(
        config, (model, optimizer), mesh=mesh)
    if mesh is not None:
        replicate(mesh, model)
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
                    shuffle_rng, post_update=clamp, mesh=mesh))
        else:
            run_epochs(step, x_data, y_data, seed=seed,
                       epochs=config["epochs"],
                       batch_size=config["batch_size"],
                       start_epoch=start_epoch, on_epoch=on_epoch,
                       post_update=clamp, mesh=mesh,
                       graph_noise=partial(NoisePlan, model)
                       if graphed else None)
    if not main_rank:
        logger.finish()
        return model, optimizer

    ckpt = os.path.join(config["assets_dir"],
                        f"tabular_{config['model']}_{dataset}")
    save_checkpoint(ckpt, export_params(model),
                    opt_state=export_opt_state(optimizer, model,
                                               decayed=True),
                    step=config["epochs"], config=config)
    # data-space serving and sampling need the fitted transformer
    atomic_write(os.path.join(ckpt, "transformer.npz"), "wb",
                 data.transformer.save)
    print(f"checkpoint saved to {ckpt}")
    logger.finish()
    return model, optimizer


if __name__ == "__main__":
    main()
