"""Distributional-robustness entry point (port of ``cdgvae_tpu/cli/
dr_robustness.py:19-69``, with ``--device`` in place of ``--platform``):
fit the downstream classifier on the first node-1 latent means (the
spurious one dropped unless ``--keep_spurious``) and report the average
and worst-group accuracy on the shifted test split.

Usage: python -m cdgvae_torch.cli.dr_robustness --checkpoint DIR
       [--device cuda]

Loads a DR checkpoint of either package, renders the DR train and test
splits with raw labels (``downstream=True``), or reads them from the PNG
tree the checkpoint's config names in ``data_dir``, and writes
``<assets_dir>/<model>_<scm>_<num>.txt`` in the reference's two lines.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..api import LoadedModel, is_dr
from ..data.pendulum_dr import PendulumDRDataset
from ..eval.downstream import robustness
from ..utils.device import resolve_device
from ..utils.simulation import set_random_seed
from .common import add_device_arg


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--num", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--keep_spurious", action="store_true",
                        help="keep the 5th (spurious) latent in the "
                             "downstream representation")
    parser.add_argument("--assets_dir", default="./assets/robustness",
                        type=str)
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    loaded = LoadedModel.load(args.checkpoint, device=device)
    config = loaded.config
    if not is_dr(config):
        raise SystemExit(f"{args.checkpoint} is not a DR checkpoint (node "
                         "5, spurious latent): train one with cli.dr_main")
    set_random_seed(config["seed"])

    splits = [PendulumDRDataset(image_size=config["image_size"], train=train,
                                downstream=True, seed=config["seed"],
                                n=config.get("n_samples", 10000),
                                device=device,
                                data_dir=config.get("data_dir") or None)
              for train in (True, False)]
    result = robustness(
        loaded.model, splits[0].x_data, splits[0].y_data.cpu().numpy(),
        splits[1].x_data, splits[1].y_data.cpu().numpy(),
        seed=config["seed"], repeats=args.repeats, epochs=args.epochs,
        drop_last_latent=not args.keep_spurious)

    os.makedirs(args.assets_dir, exist_ok=True)
    tag = f"{config['model']}_{config['scm']}_{args.num}"
    with open(f"{args.assets_dir}/{tag}.txt", "w") as f:
        f.write("average accuracy: {:.4f}\n".format(
            result["avg_accuracy"]))
        f.write("worst-group accuracy: {:.4f}\n".format(
            result["worst_group_accuracy"]))
    print(result)
    return result


if __name__ == "__main__":
    main()
