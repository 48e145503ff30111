"""Semi-supervised pendulum training (port of ``cdgvae_tpu/cli/
main_semi.py:1-173``, same flags and defaults, plus ``--device``);
:func:`train` is also the DR family's (``cli/dr_main_semi.py``).

Usage: python -m cdgvae_torch.cli.main_semi --device cuda ...

The ELBO on the unlabeled stream (the whole rendered train split) and the
alignment on a small labeled stream (its first ``--labeled_ratio`` share,
batches of ``--batch_sizeL``). ``--online`` draws every unlabeled batch
fresh from the device DGP and subsamples the labeled set, which stays on
the device. Prints one ``[epoch NNN]`` line per epoch, appends the epoch
metrics to ``<assets_dir>/metrics.jsonl``, and at the end (only then, as
the reference) writes ``recon.png`` and the checkpoint
``<assets_dir>/model_<model>_<scm>``. ``--resume`` continues from a
checkpoint of either package; ``--eager`` runs the reference's per-batch
protocol, short batches kept. On a CUDA device, without ``--eager`` or
``--dp``, both the fixed and the online trainer replay one CUDA graph a
step (``cli/common.py::graphed_epochs``), equal to the eager runners bit
for bit. ``--data_dir`` reads both streams from a
reference-format PNG tree. ``--dp N`` trains on N ranks
(``cli/common.py``): both ``--batch_size`` and ``--batch_sizeL`` divide
over them, and each rank cycles its own labeled shard.
"""
from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
import torch

from ..data.pendulum import PendulumDataset
from ..data.pendulum_dr import PendulumDRDataset
from ..factory import build_pendulum_model
from ..parallel.mesh import is_main, rank_path, replicate
from ..train.loop import format_epoch, train_epoch_semi
from ..train.online import dr_batch_fn, pendulum_batch_fn
from ..train.scanned import NoisePlan
from ..train.steps import make_optimizer, make_semi_loss_fn, make_semi_step
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.interop import export_opt_state, export_params
from ..utils.logging import MetricLogger
from ..utils.profiling import trace
from ..utils.simulation import (EPOCH, VIZ_BATCH, VIZ_NOISE,
                                derived_generator, set_random_seed)
from ..utils.viz import viz_recon_grid
from .common import (add_infra_args, add_png_data_dir_arg, add_resume_arg,
                     apply_resume, arg_as_bool, arg_as_list, graphed_epochs,
                     run_online_training, run_scanned_training_semi,
                     train_on_mesh)


def get_args(argv=None, **defaults):
    """The flags; ``defaults`` overrides their defaults (the DR CLI's)."""
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--model", type=str, default="CDGVAEsemi")
    parser.add_argument("--node", default=4, type=int)
    parser.add_argument("--scm", default="nonlinear", type=str)
    parser.add_argument("--flow_num", default=1, type=int)
    parser.add_argument("--inverse_loop", default=100, type=int)
    parser.add_argument("--factor", default=[1, 1, 2], type=arg_as_list)
    parser.add_argument("--labeled_ratio", default=0.1, type=float)
    parser.add_argument("--label_normalization", default=True,
                        type=arg_as_bool)
    parser.add_argument("--adjacency_scaling", default=True, type=arg_as_bool)
    parser.add_argument("--image_size", default=64, type=int)
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--batch_sizeL", default=32, type=int,
                        help="batch size for the labeled stream")
    parser.add_argument("--lr", default=0.001, type=float)
    parser.add_argument("--beta", default=0.1, type=float)
    parser.add_argument("--lambda", default=5, type=float)
    parser.add_argument("--online", action="store_true",
                        help="every step draws a fresh unlabeled batch from "
                             "the device DGP and renders it; the labeled "
                             "set stays fixed on the device and is "
                             "subsampled each step")
    add_png_data_dir_arg(parser)
    add_resume_arg(parser)
    add_infra_args(parser)
    parser.set_defaults(**defaults)
    return parser.parse_args(argv)


def main(argv=None):
    config = vars(get_args(argv))
    config["spurious"] = False  # family marker for checkpoint loaders (api.py)
    return train_on_mesh(train, config,
                         extra_batch_sizes=(config["batch_sizeL"],))


def train(config: dict, mesh=None):
    """Train the semi-supervised model of ``config`` (the parsed flags)
    and save it. ``config["spurious"]`` picks the family: the pendulum
    family, or the DR family (``PendulumDRDataset`` or ``dr_batch_fn``,
    the spurious decoder wiring, the checkpoint ``model_DR_<model>_<scm>``
    and, as the reference's DR trainer, no ``recon.png``). Under a
    ``mesh`` this is one rank of the run."""
    if config["online"] and (config["eager"] or config.get("data_dir")):
        raise SystemExit("--online supports the scanned path on the "
                         "synthetic DGP only")
    dr = config["spurious"]
    device = mesh.device if mesh is not None else resolve_device(
        config["device"])
    main_rank = is_main(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    set_random_seed(config["seed"])
    seed = config["seed"]
    logger = MetricLogger(logdir=config["assets_dir"] if main_rank else None,
                          use_wandb=config["wandb"] and main_rank,
                          tags=["VAEBased", "DR", "semi"] if dr
                          else ["VAEBased", "semi"], config=config)

    dataset_cls = PendulumDRDataset if dr else PendulumDataset
    data_dir = config.get("data_dir") or None
    labeled = dataset_cls(
        image_size=config["image_size"], train=True,
        labeled_ratio=config["labeled_ratio"],
        label_normalization=config["label_normalization"], seed=seed,
        n=config["n_samples"], device=device, data_dir=data_dir)
    x_l, y_l = labeled.x_data, labeled.y_data
    if not config["online"]:
        x_u = dataset_cls(image_size=config["image_size"], train=True,
                          seed=seed, n=config["n_samples"],
                          device=device, data_dir=data_dir).x_data

    model, _ = build_pendulum_model(config, spurious=dr, device=device,
                                    seed=seed)
    graphed = graphed_epochs(config, device, mesh)
    graph_noise = partial(NoisePlan, model) if graphed else None
    optimizer = make_optimizer(model, config["lr"], capturable=graphed)
    (model, optimizer), start_epoch = apply_resume(
        config, (model, optimizer), mesh=mesh)
    if mesh is not None:
        replicate(mesh, model)
    os.makedirs(config["assets_dir"], exist_ok=True)

    def on_epoch(epoch, metrics):
        if main_rank:
            print(format_epoch(epoch, metrics), flush=True)
            logger.log(metrics, step=epoch)

    beta, lam = config["beta"], config["lambda"]
    with trace(config["profile"] if main_rank else ""):
        if config["online"]:
            def sample_builder(batch_size):
                return (dr_batch_fn if dr else pendulum_batch_fn)(
                    batch_size, config["image_size"], norm_seed=seed,
                    norm_n=config["n_samples"], device=device)
            run_online_training(
                config, loss_fn=make_semi_loss_fn(model, beta, lam),
                optimizer=optimizer, device=device, start_epoch=start_epoch,
                on_epoch=on_epoch, sample_batch_builder=sample_builder,
                labeled=(x_l, y_l), mesh=mesh, graph_noise=graph_noise)
        elif config["eager"]:
            step = make_semi_step(model, optimizer, beta, lam, mesh)
            shuffle_rng = np.random.default_rng(seed + start_epoch)
            for epoch in range(start_epoch, config["epochs"]):
                on_epoch(epoch, train_epoch_semi(
                    step, x_u, x_l, y_l, config["batch_size"],
                    config["batch_sizeL"],
                    derived_generator(seed, EPOCH, epoch, *rank_path(mesh),
                                      device=device),
                    shuffle_rng, mesh=mesh))
        else:
            run_scanned_training_semi(
                config, step=make_semi_step(model, optimizer, beta, lam,
                                            mesh),
                data=(x_u, x_l, y_l), start_epoch=start_epoch,
                on_epoch=on_epoch, mesh=mesh, graph_noise=graph_noise)

    if not main_rank:
        logger.finish()
        return model, optimizer
    if not dr:
        # under --online there is no unlabeled dataset: a fresh 9-image
        # draw
        x_viz = (sample_builder(9)(derived_generator(seed, VIZ_BATCH,
                                                     device=device))[0]
                 if config["online"] else x_u[:9])
        with torch.no_grad():
            xhat = model(x_viz, generator=derived_generator(
                seed, VIZ_NOISE, device=device), fast=True).xhat
        viz_recon_grid(xhat.cpu().numpy(),
                       f"{config['assets_dir']}/recon.png")

    ckpt = os.path.join(config["assets_dir"],
                        f"model_{'DR_' if dr else ''}{config['model']}_"
                        f"{config['scm']}")
    save_checkpoint(ckpt, export_params(model),
                    opt_state=export_opt_state(optimizer, model),
                    step=config["epochs"], config=config)
    print(f"checkpoint saved to {ckpt}")
    logger.finish()
    return model, optimizer


if __name__ == "__main__":
    main()
