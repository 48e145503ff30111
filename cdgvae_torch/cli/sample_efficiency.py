"""Downstream sample-efficiency entry point (port of ``cdgvae_tpu/cli/
sample_efficiency.py:18-64``, with ``--device`` in place of
``--platform``): acc(100 training labels) / acc(all labels), ``--repeats``
fits each.

Usage: python -m cdgvae_torch.cli.sample_efficiency --checkpoint DIR
       [--device cuda]

Loads a pendulum checkpoint of either package, renders the train and test
splits with raw labels (``downstream=True``), or reads them from the PNG
tree the checkpoint's config names in ``data_dir``, and writes
``<assets_dir>/<model>_<scm>_<num>.txt`` in the reference's three lines.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..api import LoadedModel
from ..data.pendulum import PendulumDataset
from ..eval.downstream import sample_efficiency
from ..utils.device import resolve_device
from ..utils.simulation import set_random_seed
from .common import add_device_arg


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--num", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--assets_dir", default="./assets/sample_efficiency",
                        type=str)
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    loaded = LoadedModel.load(args.checkpoint, device=device)
    config = loaded.config
    set_random_seed(config["seed"])

    # downstream=True keeps the raw labels for the target logit
    splits = [PendulumDataset(image_size=config["image_size"], train=train,
                              downstream=True, seed=config["seed"],
                              n=config.get("n_samples", 10000),
                              device=device,
                              data_dir=config.get("data_dir") or None)
              for train in (True, False)]
    result = sample_efficiency(
        loaded.model, splits[0].x_data, splits[0].y_data.cpu().numpy(),
        splits[1].x_data, splits[1].y_data.cpu().numpy(),
        seed=config["seed"], repeats=args.repeats)

    os.makedirs(args.assets_dir, exist_ok=True)
    tag = f"{config['model']}_{config['scm']}_{args.num}"
    with open(f"{args.assets_dir}/{tag}.txt", "w") as f:
        f.write("100 samples accuracy: {:.4f}\n".format(
            result["accuracy_100"]))
        f.write("all samples accuracy: {:.4f}\n".format(
            result["accuracy_all"]))
        f.write("sample efficiency: {:.4f}\n".format(
            result["sample_efficiency"]))
    print(result)
    return result


if __name__ == "__main__":
    main()
