"""CelebA CDG-VAE training entry point (port of ``cdgvae_tpu/cli/
celeba_main.py``, the same flags and defaults, plus ``--device``).

Usage: python -m cdgvae_torch.cli.celeba_main [--device cuda] ...

Trains on the npy corpus under ``--data_dir`` (``data/celeba.py``), or on
64 synthetic faces when it is absent, at ``--img_size`` (128) with a
ResNet-18 encoder (frozen unless ``--train_trunk``; ``--torch_weights``
imports a torchvision state dict into it) and five SAGAN generators of
width ``--conv_dim`` (32). Each epoch is one permutation of the dataset in
full batches (``--eager``: a numpy shuffle, the same full batches); after
every Adam step each spectral-norm site advances one power iteration.
Prints one ``[epoch NNN]`` line an epoch, appends the metrics to
``<assets_dir>/metrics.jsonl``, and every ``--ckpt_every`` epochs (on
epoch e where ``(e + 1) % N == 0``) writes the recon grid
``tmp_image_<e>.png`` and the checkpoint ``<assets_dir>/celeba_<model>_
<scm>`` (the JAX package's layout; ``--async_ckpt true`` writes it from a
background thread), which is written again at the end.

``--resume`` continues from a checkpoint of either package, in its own
decoder format; ``--stacked_decoder true`` writes a new run's checkpoints
in the stacked format (``decoder.stacked``), which the port trains as five
per-generator modules. ``--align_warmup N`` trains the first N epochs on
the alignment loss alone. ``--bf16`` runs the network in bfloat16 with
float32 losses and optimizer. The CelebA entry points compute in float32:
TF32 is off for matmuls and for cuDNN convolutions.

``--packed_params`` (true by default, as in the JAX package) trains in
the packed layout (``ops/packing.py``): the small trained parameters are
views of one flat buffer per dtype, which Adam steps, and in bfloat16 each
buffer is cast once a step; the checkpoint is the same either way, so
either setting resumes the other. ``--chunk`` (epochs a TPU dispatch; the
port syncs once an epoch) is accepted and recorded, and selects nothing.
``--dp N`` trains on N ranks (``cli/common.py``), ``sn_refresh`` after
every step on each: the epoch trainer normalises each rank's batch with
its own BatchNorm statistics, as the JAX package's sharded trainer does,
and ``--eager`` with the global batch's, as its GSPMD step does.
``--wandb`` logs metrics but publishes no model artifact, which needs a
network.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.celeba import CelebADataset
from ..factory import build_celeba_model
from ..models.celeba import is_stacked, stack_decoder, unstack_decoder
from ..models.sagan import sn_refresh
from ..ops.packing import Packer
from ..parallel.mesh import is_main, rank_path, replicate
from ..train.celeba_steps import make_celeba_step
from ..train.loop import format_epoch, run_epochs, train_epoch
from ..train.steps import make_optimizer
from ..utils.checkpoint import AsyncCheckpointer, save_checkpoint
from ..utils.device import resolve_device
from ..utils.interop import export_opt_state, export_params
from ..utils.logging import MetricLogger
from ..utils.profiling import trace
from ..utils.simulation import (EPOCH, VIZ_NOISE, derived_generator,
                                set_random_seed)
from ..utils.viz import viz_recon_grid
from .common import (add_infra_args, add_resume_arg, apply_resume,
                     arg_as_bool, train_on_mesh)


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--model", type=str, default="CDGVAE")
    parser.add_argument("--causal_structure", default=0, type=int,
                        help="0: smile, 1: attractive")
    parser.add_argument("--node", default=6, type=int)
    parser.add_argument("--latent_dim", default=6, type=int)
    parser.add_argument("--scm", default="linear", type=str)
    parser.add_argument("--flow_num", default=1, type=int)
    parser.add_argument("--inverse_loop", default=100, type=int)
    parser.add_argument("--labeled_ratio", default=1, type=float)
    parser.add_argument("--label_normalization", default=True,
                        type=arg_as_bool)
    parser.add_argument("--adjacency_scaling", default=True, type=arg_as_bool)
    parser.add_argument("--img_size", default=128, type=int)
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--lr", default=0.001, type=float)
    parser.add_argument("--beta", default=0.1, type=float)
    parser.add_argument("--lambda", default=5, type=float)
    parser.add_argument("--data_dir", default="./data", type=str)
    parser.add_argument("--conv_dim", default=32, type=int)
    parser.add_argument("--train_trunk", action="store_true",
                        help="train the encoder trunk end to end instead of "
                             "freezing it")
    parser.add_argument("--torch_weights", default="", type=str,
                        help="a torchvision-layout resnet18 state dict "
                             "(torch.save) to import into the encoder trunk "
                             "before training; its BatchNorm running "
                             "statistics are used (eval-mode normalisation)")
    parser.add_argument("--stacked_decoder", default=False, type=arg_as_bool,
                        help="write checkpoints in the stacked decoder "
                             "format (decoder.stacked); training runs the "
                             "five generators as separate modules either "
                             "way. A resumed run keeps its checkpoint's "
                             "format")
    parser.add_argument("--align_warmup", default=0, type=int,
                        help="train the first N epochs on the alignment "
                             "loss alone (loss = lambda * align), then on "
                             "the reference objective; 0 = the reference "
                             "protocol")
    parser.add_argument("--packed_params", default=True, type=arg_as_bool,
                        help="train the small parameters as views of one "
                             "flat buffer per dtype, which Adam steps "
                             "(false: one tensor each); checkpoints are "
                             "the same either way")
    parser.add_argument("--bf16", action="store_true",
                        help="run the network in bfloat16 (parameters, "
                             "losses and optimizer stay float32)")
    parser.add_argument("--chunk", default=10, type=int,
                        help="accepted and recorded; selects nothing here "
                             "(epochs a TPU dispatch; the port syncs once "
                             "an epoch)")
    parser.add_argument("--ckpt_every", default=10, type=int,
                        help="epochs between mid-run checkpoint and recon "
                             "saves, on epoch e where (e + 1) %% N == 0; "
                             "<= 0 disables them (the final save always "
                             "runs)")
    parser.add_argument("--async_ckpt", default=False, type=arg_as_bool,
                        help="write mid-run checkpoints from a background "
                             "thread, from a snapshot on the device; the "
                             "final save is synchronous")
    add_resume_arg(parser)
    add_infra_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    return train_on_mesh(train, vars(get_args(argv)))


def train(config: dict, mesh=None):
    """Train the CelebA model of ``config`` (the parsed flags) and save it;
    under a ``mesh`` this is one rank of the run."""
    device = mesh.device if mesh is not None else resolve_device(
        config["device"])
    main_rank = is_main(mesh)
    # float32 on the card as on the CPU: no TF32 in matmuls or in cuDNN's
    # convolutions (PyTorch's default for the latter is TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_random_seed(config["seed"])
    seed = config["seed"]
    logger = MetricLogger(logdir=config["assets_dir"] if main_rank else None,
                          use_wandb=config["wandb"] and main_rank,
                          tags=["CelebA"], config=config)
    if config["wandb"] and main_rank:
        print("--wandb: metrics are logged; the model artifact is not "
              "published (it needs a network)")

    dataset = CelebADataset(data_dir=config["data_dir"],
                            causal_structure=config["causal_structure"],
                            train=True, img_size=config["img_size"],
                            seed=seed)
    x_data = torch.as_tensor(dataset.x_data, device=device)
    y_data = torch.as_tensor(dataset.y_data, device=device)

    model = build_celeba_model(config, device=device, seed=seed)
    if config["torch_weights"]:
        sd = torch.load(config["torch_weights"], map_location="cpu")
        model.encoder.load_torch_weights(sd)
        if main_rank:
            print("imported torchvision trunk from "
                  f"{config['torch_weights']}")
    packer = Packer(model) if config["packed_params"] else None
    optimizer = make_optimizer(model, config["lr"], packer=packer)
    stacked = config["stacked_decoder"]

    def canonical(ck):
        nonlocal stacked
        # a resumed run keeps its checkpoint's decoder format
        loaded = is_stacked(ck["params"])
        if loaded != config["stacked_decoder"] and main_rank:
            print(f"WARNING: resumed checkpoint stores a "
                  f"{'stacked' if loaded else 'per-generator'} decoder; "
                  f"--stacked_decoder {config['stacked_decoder']} is "
                  "ignored, its checkpoints keep the checkpoint's format")
        stacked = loaded
        params = unstack_decoder(ck["params"], model.z_dims)
        adam = ck["opt_state"][0]
        ck["opt_state"] = (adam._replace(
            mu=unstack_decoder(adam.mu, model.z_dims),
            nu=unstack_decoder(adam.nu, model.z_dims)),
            *ck["opt_state"][1:])
        model.adapt_to(params)
        ck["params"] = params
        return ck

    (model, optimizer), start_epoch = apply_resume(
        config, (model, optimizer), prepare=canonical, mesh=mesh)
    if mesh is not None:
        replicate(mesh, model)
    os.makedirs(config["assets_dir"], exist_ok=True)
    ckpt = os.path.join(config["assets_dir"],
                        f"celeba_{config['model']}_{config['scm']}")
    saver = AsyncCheckpointer() if config["async_ckpt"] and main_rank \
        else None
    x_viz = x_data[: min(9, len(x_data))]
    beta, lam, bs = config["beta"], config["lambda"], config["batch_size"]
    dtype = torch.bfloat16 if config["bf16"] else None
    refresh = lambda: sn_refresh(model)  # noqa: E731

    def trees(host: bool):
        params = export_params(model, host=host)
        adam, empty = export_opt_state(optimizer, model, host=host)
        if stacked:
            params = stack_decoder(params, model.z_dims)
            adam = adam._replace(mu=stack_decoder(adam.mu, model.z_dims),
                                 nu=stack_decoder(adam.nu, model.z_dims))
        return params, (adam, empty)

    def post_epoch(epoch):
        if not main_rank:
            return
        with torch.no_grad():
            xhat = model(x_viz, generator=derived_generator(
                seed, VIZ_NOISE, device=device)).xhat
        viz_recon_grid(xhat.float().cpu().numpy(),
                       f"{config['assets_dir']}/tmp_image_{epoch}.png",
                       n=len(x_viz))
        if saver is not None:
            params, opt_state = trees(host=False)
            saver.save(ckpt, params, opt_state=opt_state, step=epoch + 1,
                       config=config)
        else:
            params, opt_state = trees(host=True)
            save_checkpoint(ckpt, params, opt_state=opt_state,
                            step=epoch + 1, config=config)

    def ckpt_due(epoch):
        return config["ckpt_every"] > 0 \
            and (epoch + 1) % config["ckpt_every"] == 0

    def on_epoch(epoch, metrics):
        if main_rank:
            print(format_epoch(epoch, metrics), flush=True)
            logger.log(metrics, step=epoch)

    # alignment-first warmup: epochs [start, warm) on the alignment loss,
    # then [max(start, warm), epochs) on the reference objective
    warm = min(config["align_warmup"], config["epochs"])
    phases = []
    if warm > start_epoch:
        phases.append((start_epoch, warm, True))
    if config["epochs"] > max(start_epoch, warm):
        phases.append((max(start_epoch, warm), config["epochs"], False))
    shuffle_rng = np.random.default_rng(seed + start_epoch)
    with trace(config["profile"] if main_rank else ""):
        for e0, e1, align_only in phases:
            step = make_celeba_step(model, optimizer, beta, lam,
                                    compute_dtype=dtype,
                                    align_only=align_only, mesh=mesh,
                                    global_stats=config["eager"])
            if config["eager"]:
                for epoch in range(e0, e1):
                    on_epoch(epoch, train_epoch(
                        step, x_data, y_data, bs,
                        derived_generator(seed, EPOCH, epoch,
                                          *rank_path(mesh), device=device),
                        shuffle_rng, post_update=refresh,
                        drop_remainder=True, mesh=mesh))
                    if ckpt_due(epoch):
                        post_epoch(epoch)
            else:
                run_epochs(step, x_data, y_data, seed=seed, epochs=e1,
                           batch_size=bs, start_epoch=e0, on_epoch=on_epoch,
                           post_epoch=post_epoch, post_epoch_pred=ckpt_due,
                           post_update=refresh, mesh=mesh)

    if not main_rank:
        logger.finish()
        return model, optimizer
    if saver is not None:
        saver.wait()  # the mid-run save in flight, and its errors
    params, opt_state = trees(host=True)
    save_checkpoint(ckpt, params, opt_state=opt_state,
                    step=config["epochs"], config=config)
    print(f"checkpoint saved to {ckpt}")
    logger.finish()
    return model, optimizer


if __name__ == "__main__":
    main()
