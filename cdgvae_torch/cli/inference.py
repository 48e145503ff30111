"""Counterfactual inference entry point (port of ``cdgvae_tpu/cli/
inference.py:1-92``, with ``--device`` in place of ``--platform``).

Usage: python -m cdgvae_torch.cli.inference --checkpoint DIR [--device cuda]

Loads a checkpoint of either package (its config is embedded), rebuilds
the model and writes the reference's diagnostic set to ``--assets_dir``:
``latent_maxmin_orig.png``, ``latent_maxmin.png``,
``posterior_variance.png`` and ``crossentropy.png`` (bars, their values
printed), ``original_and_recon.png`` (the 8th image), ``gam.png`` (the
per-block GAM outputs, CDG-VAE only) and ``do.png`` (the node x 7
do-intervention grid). The model loads as ``api.LoadedModel`` does, a DR
checkpoint with its spurious wiring; as in the reference, its diagnostics
still run on the plain pendulum dataset, whose name list gives the 5th
latent the label "target". The train split is rendered, or read from the
PNG tree the checkpoint's config names in ``data_dir``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..api import LoadedModel
from ..data.pendulum import PendulumDataset
from ..eval.inference import (alignment_cross_entropy, do_grid,
                              encode_dataset, latent_ranges)
from ..utils.device import resolve_device
from ..utils.simulation import set_random_seed
from ..utils.viz import viz_bars, viz_do_grid, viz_gam_blocks, viz_pair
from .common import add_device_arg


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="checkpoint directory written by cli.main")
    parser.add_argument("--assets_dir", default="./assets/inference",
                        type=str)
    add_device_arg(parser)
    return parser.parse_args(argv)


@torch.no_grad()
def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    loaded = LoadedModel.load(args.checkpoint, device=device)
    model, config = loaded.model, loaded.config
    set_random_seed(config["seed"])

    dataset = PendulumDataset(
        image_size=config["image_size"], train=True, seed=config["seed"],
        label_normalization=config.get("label_normalization", True),
        n=config.get("n_samples", 10000), device=device,
        data_dir=config.get("data_dir") or None)
    x_data = dataset.x_data
    names = dataset.name[: model.node]

    os.makedirs(args.assets_dir, exist_ok=True)
    out_dir = args.assets_dir
    encoded = encode_dataset(model, x_data)
    omin, omax, lmin, lmax = latent_ranges(encoded)
    viz_bars(np.abs(omax - omin), names, "latent (intervened)",
             f"{out_dir}/latent_maxmin_orig.png")
    viz_bars(np.abs(lmax - lmin), names, "transformed latent",
             f"{out_dir}/latent_maxmin.png")
    viz_bars(np.exp(encoded["logvar"]).mean(axis=0), names,
             "posterior variance", f"{out_dir}/posterior_variance.png",
             ylim=(0, 1))
    viz_bars(alignment_cross_entropy(encoded, dataset.y_data), names,
             "latent", f"{out_dir}/crossentropy.png")

    # the 8th image, as the reference
    x_sample = x_data[7:8]
    out = model(x_sample, deterministic=True)
    viz_pair(x_sample[0].cpu().numpy(), out.xhat[0].cpu().numpy(),
             f"{out_dir}/original_and_recon.png")
    if out.xhat_separated is not None:
        size = config["image_size"]
        viz_gam_blocks(out.xhat_separated.reshape(
            model.K, size, size, 3).cpu().numpy(), f"{out_dir}/gam.png")

    grid = do_grid(model, x_sample, lmin, lmax)
    viz_do_grid(grid, f"{out_dir}/do.png", row_names=names)
    print(f"wrote diagnostics to {out_dir}")
    return grid


if __name__ == "__main__":
    main()
