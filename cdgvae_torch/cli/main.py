"""Pendulum training entry point, the VAE, InfoMax and CDGVAE paths of
``cdgvae_tpu/cli/main.py:30-334`` with the same flag names and defaults,
plus ``--device``; :func:`train` is also the DR family's trainer
(``cli/dr_main.py``).

Usage: python -m cdgvae_torch.cli.main --model CDGVAE --device cuda ...

Trains on the rendered pendulum_real train split (cut to its first
``--labeled_ratio`` share, or, with ``--online``, a fresh device-rendered
batch every step), prints one ``[epoch NNN]`` line per epoch, appends the
epoch metrics to ``<assets_dir>/metrics.jsonl``, writes the recon figure
every 10 epochs and ``recon.png`` at the end, and saves a checkpoint (the
JAX package's layout) to ``<assets_dir>/model_<model>_<scm>`` every 25
epochs and at the end. InfoMax trains the VAE with the MI discriminator
(its checkpoint carries ``extras={"d_params", "opt_state_d"}``) and, as in
the reference, skips the mid-run checkpoints. ``--resume`` continues from
a checkpoint of either package. ``--eager`` runs the per-batch protocol
that keeps the last partial batch. On a CUDA device the VAE and CDG-VAE
epochs on a fixed dataset replay one CUDA graph a step
(``cli/common.py::graphed_epochs``), equal to the eager epochs.
``--data_dir`` trains on a reference-format PNG tree
(``cli/generate_data.py`` writes one) instead of the rendered DGP. ``--dp N`` trains on N ranks (``cli/common.py``),
InfoMax then with the ``"roll"`` marginal on each rank's batch.
``--wandb`` logs the metrics but publishes no model artifact, which needs
a network.
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
from ..train.loop import format_epoch, train_epoch
from ..train.online import dr_batch_fn, pendulum_batch_fn
from ..train.scanned import NoisePlan
from ..train.steps import (make_infomax_loss_fn, make_infomax_step,
                           make_optimizer, make_train_step,
                           pair_infomax_optimizer)
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
                     run_online_training, run_scanned_training,
                     train_on_mesh)


def get_args(argv=None, **defaults):
    """The flags; ``defaults`` overrides their defaults (the DR CLI's)."""
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=1,
                        help="seed for repeatable results")
    parser.add_argument("--model", type=str, default="CDGVAE",
                        help="VAE based model options: VAE, InfoMax, CDGVAE")
    parser.add_argument("--node", default=4, type=int,
                        help="the number of nodes")
    parser.add_argument("--scm", default="linear", type=str,
                        help="SCM structure options: linear or nonlinear")
    parser.add_argument("--flow_num", default=1, type=int,
                        help="the number of invertible NN flow")
    parser.add_argument("--inverse_loop", default=100, type=int,
                        help="the number of inverse loop")
    parser.add_argument("--factor", default=[1, 1, 2], type=arg_as_list,
                        help="Numbers of latents allocated to each factor")
    parser.add_argument("--labeled_ratio", default=1, type=float,
                        help="ratio of labeled dataset for semi-supervised")
    parser.add_argument("--label_normalization", default=True,
                        type=arg_as_bool,
                        help="If True, normalize additional label data")
    parser.add_argument("--adjacency_scaling", default=True, type=arg_as_bool,
                        help="If True, scale adjacency matrix by in-degree")
    parser.add_argument("--image_size", default=64, type=int,
                        help="width and height of image")
    parser.add_argument("--epochs", default=100, type=int,
                        help="maximum iteration")
    parser.add_argument("--batch_size", default=128, type=int,
                        help="batch size")
    parser.add_argument("--lr", default=0.001, type=float,
                        help="learning rate")
    parser.add_argument("--lr_D", default=0.0001, type=float,
                        help="learning rate for discriminator in InfoMax")
    parser.add_argument("--beta", default=0.1, type=float,
                        help="observation noise")
    parser.add_argument("--lambda", default=5, type=float,
                        help="weight of label alignment loss")
    parser.add_argument("--free_bits", default=0.0, type=float,
                        help="floor the per-dim KL at this many nats "
                             "(0 = the reference objective; VAE/CDGVAE "
                             "only)")
    parser.add_argument("--gamma", default=1, type=float,
                        help="weight of f-divergence (InfoMax)")
    parser.add_argument("--online", action="store_true",
                        help="fresh-data-per-step training: every step "
                             "draws a new batch from the pendulum_real DGP "
                             "and renders it on the device")
    add_png_data_dir_arg(parser)
    add_resume_arg(parser)
    add_infra_args(parser)
    parser.set_defaults(**defaults)
    return parser.parse_args(argv)


def _refuse_unsupported(config: dict):
    if config["free_bits"] and config["model"] == "InfoMax":
        raise SystemExit("--free_bits targets the supervised VAE/CDGVAE "
                         "objective; the InfoMax path does not wire it")
    if config["online"] and (config["eager"] or config.get("data_dir")
                             or config["labeled_ratio"] < 1
                             or not config["label_normalization"]):
        raise SystemExit("--online supports the scanned path on the "
                         "synthetic DGP with full labels and "
                         "label_normalization only")


def main(argv=None):
    config = vars(get_args(argv))
    config["spurious"] = False  # family marker for checkpoint loaders (api.py)
    return train_on_mesh(train, config)


def train(config: dict, mesh=None):
    """Train the model of ``config`` (the parsed flags) and save it. The
    family marker ``config["spurious"]`` picks the data: the pendulum
    family, or the DR family (``PendulumDRDataset`` or ``dr_batch_fn``,
    the spurious decoder wiring, the checkpoint ``model_DR_<model>_<scm>``
    and, as the reference's DR trainer, neither mid-run checkpoints nor
    ``recon.png``). Under a ``mesh`` this is one rank of the run."""
    _refuse_unsupported(config)
    dr = config["spurious"]
    device = mesh.device if mesh is not None else resolve_device(
        config["device"])
    main_rank = is_main(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    set_random_seed(config["seed"])
    seed, bs = config["seed"], config["batch_size"]
    infomax = config["model"] == "InfoMax"
    marginal = "permutation" if mesh is None else "roll"
    logger = MetricLogger(logdir=config["assets_dir"] if main_rank else None,
                          use_wandb=config["wandb"] and main_rank,
                          tags=["VAEBased", "DR"] if dr else ["VAEBased"],
                          config=config)
    if config["wandb"] and main_rank:
        print("--wandb: metrics are logged; the model artifact is not "
              "published (it needs a network)")

    if not config["online"]:
        dataset = (PendulumDRDataset if dr else PendulumDataset)(
            image_size=config["image_size"], train=True,
            labeled_ratio=config["labeled_ratio"],
            label_normalization=config["label_normalization"],
            seed=seed, n=config["n_samples"], device=device,
            data_dir=config.get("data_dir") or None)
    model, discriminator = build_pendulum_model(config, spurious=dr,
                                                device=device, seed=seed)
    # the pendulum supervised epochs replay CUDA graphs on the card; the
    # InfoMax pair and the DR family stay eager
    graphed = graphed_epochs(config, device, mesh) and not infomax and not dr
    optimizer = make_optimizer(model, config["lr"], capturable=graphed)
    beta, lam = config["beta"], config["lambda"]
    if infomax:
        optimizer_d = make_optimizer(discriminator, config["lr_D"])
        state = (model, discriminator, optimizer, optimizer_d)
        step = make_infomax_step(model, discriminator, optimizer,
                                 optimizer_d, beta, lam, config["gamma"],
                                 marginal, mesh)
    else:
        state = (model, optimizer)
        step = make_train_step(model, optimizer, beta, lam,
                               free_bits=config["free_bits"], mesh=mesh)
    state, start_epoch = apply_resume(config, state, mesh=mesh)
    if mesh is not None:
        replicate(mesh, *state[:len(state) // 2])
    shuffle_rng = np.random.default_rng(seed + start_epoch)
    os.makedirs(config["assets_dir"], exist_ok=True)
    ckpt = os.path.join(config["assets_dir"],
                        f"model_{'DR_' if dr else ''}{config['model']}_"
                        f"{config['scm']}")

    # the viz batch: a training-batch-sized slice, or under --online one
    # draw of the online DGP (a batch function of its own, so the
    # trainer's image buffer never overwrites it); only rank 0 draws it
    if config["online"]:
        def sample_builder(batch_size):
            return (dr_batch_fn if dr else pendulum_batch_fn)(
                batch_size, config["image_size"], norm_seed=seed,
                norm_n=config["n_samples"], device=device)
        x_viz = sample_builder(bs)(
            derived_generator(seed, VIZ_BATCH, device=device))[0] \
            if main_rank else None
    else:
        x_viz = dataset.x_data[:min(bs, len(dataset))]

    def viz(path):
        with torch.no_grad():
            out = model(x_viz, generator=derived_generator(
                seed, VIZ_NOISE, device=device), fast=True)
        viz_recon_grid(out.xhat[:9].cpu().numpy(), path)

    def save(step):
        extras = None
        if infomax:
            extras = {"d_params": export_params(discriminator),
                      "opt_state_d": export_opt_state(optimizer_d,
                                                      discriminator)}
        save_checkpoint(ckpt, export_params(model),
                        opt_state=export_opt_state(optimizer, model),
                        step=step, config=config, extras=extras)

    def ckpt_due(epoch):
        return (not dr and (epoch + 1) % 25 == 0
                and epoch + 1 < config["epochs"])

    def viz_due(epoch):
        return epoch % 10 == 0

    def post_epoch(epoch):
        if not main_rank:
            return
        # the reference skips InfoMax's mid-run checkpoints (its hook sees
        # only the model's state); the final one carries the extras
        if ckpt_due(epoch) and not infomax:
            save(epoch + 1)
        if viz_due(epoch):
            viz(f"{config['assets_dir']}/tmp_image_{epoch}.png")

    def on_epoch(epoch, metrics):
        if main_rank:
            print(format_epoch(epoch, metrics), flush=True)
            logger.log(metrics, step=epoch)

    pred = lambda e: ckpt_due(e) or viz_due(e)  # noqa: E731
    with trace(config["profile"] if main_rank else ""):
        if config["online"]:
            if infomax:
                loss_fn = make_infomax_loss_fn(model, discriminator, beta,
                                               lam, config["gamma"],
                                               marginal)
                opt = pair_infomax_optimizer(optimizer, optimizer_d)
            else:
                from ..train.scanned import make_supervised_loss_fn
                loss_fn = make_supervised_loss_fn(
                    model, beta, lam, free_bits=config["free_bits"])
                opt = optimizer
            run_online_training(
                config, loss_fn=loss_fn, optimizer=opt, device=device,
                start_epoch=start_epoch, on_epoch=on_epoch,
                sample_batch_builder=sample_builder, post_epoch=post_epoch,
                post_epoch_pred=pred, mesh=mesh)
        elif not config["eager"]:
            run_scanned_training(
                config, step=step, data=(dataset.x_data, dataset.y_data),
                start_epoch=start_epoch, on_epoch=on_epoch,
                post_epoch=post_epoch, post_epoch_pred=pred, mesh=mesh,
                graph_noise=partial(NoisePlan, model) if graphed else None)
        else:
            for epoch in range(start_epoch, config["epochs"]):
                metrics = train_epoch(
                    step, dataset.x_data, dataset.y_data, bs,
                    derived_generator(seed, EPOCH, epoch, *rank_path(mesh),
                                      device=device),
                    shuffle_rng, mesh=mesh)
                on_epoch(epoch, metrics)
                post_epoch(epoch)

    if main_rank:
        if not dr:
            viz(f"{config['assets_dir']}/recon.png")
            logger.log_image("reconstruction",
                             f"{config['assets_dir']}/recon.png")
        save(config["epochs"])
        print(f"checkpoint saved to {ckpt}")
    logger.finish()
    return state


if __name__ == "__main__":
    main()
