"""CDM metric entry point (port of ``cdgvae_tpu/cli/metric.py:1-90``,
with ``--device`` in place of ``--platform``).

Usage: python -m cdgvae_torch.cli.metric --checkpoint DIR
       --classifier_checkpoint DIR [--device cuda]

Loads a trained VAE/CDG-VAE checkpoint (of either package) and the CDM
factor classifier's, computes the node x node CDM lower/upper matrices on
the train split (rendered, or read from the PNG tree the checkpoint's
config names in ``data_dir``), prints them, and writes
``lower_<tag>.csv``/``upper_<tag>.csv`` (the text ``pandas.DataFrame(m.
round(3), columns=names, index=names).to_csv`` writes, through the
``csv`` module) and their heatmaps, ``tag = <model>_<scm>_<num>``. The
model loads as ``api.LoadedModel`` does. A DR checkpoint is refused: the
JAX metric cannot build one either (it builds the model without the
spurious wiring, and node 5 is not the sum of the 4 factor latents).
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ..api import LoadedModel, is_dr
from ..data.pendulum import PendulumDataset
from ..eval.metric import cdm_matrices
from ..models.classifier import FactorClassifier
from ..utils.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.interop import load_jax_params
from ..utils.simulation import set_random_seed
from ..utils.viz import viz_heatmap
from .common import add_device_arg
from .main_classifier import classifier_masks


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="trained model checkpoint directory")
    parser.add_argument("--classifier_checkpoint", type=str, required=True,
                        help="CDMClassifier checkpoint directory")
    parser.add_argument("--num", type=int, default=0,
                        help="repeat id used in output filenames")
    parser.add_argument("--assets_dir", default="./assets/CDM", type=str)
    add_device_arg(parser)
    return parser.parse_args(argv)


def write_matrix_csv(path: str, matrix: np.ndarray, names) -> None:
    """``matrix`` rounded to 3 decimals with ``names`` as the header and
    the index: the layout of ``pandas.DataFrame.to_csv``."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["", *names])
        for name, row in zip(names, np.asarray(matrix).round(3)):
            writer.writerow([name, *(repr(float(v)) for v in row)])


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # exact structural zeros
    if is_dr(load_checkpoint(args.checkpoint)["config"] or {}):
        raise SystemExit(
            f"{args.checkpoint} is a DR checkpoint (node 5, spurious "
            "latent): the CDM metric scores the pendulum family only, as "
            "the JAX package's metric does")
    loaded = LoadedModel.load(args.checkpoint, device=device)
    model, config = loaded.model, loaded.config
    set_random_seed(config["seed"])

    clf_ckpt = load_checkpoint(args.classifier_checkpoint)
    # the classifier's own config: the two CLIs set image_size and node
    # apart, and a mismatch would misshape it or shift its masks
    clf_cfg = clf_ckpt["config"] or config
    if (clf_cfg["image_size"], clf_cfg["node"]) != (
            config["image_size"], config["node"]):
        raise ValueError(
            f"classifier was trained at image_size={clf_cfg['image_size']}"
            f"/node={clf_cfg['node']} but the model uses "
            f"{config['image_size']}/{config['node']} — retrain the CDM "
            "classifier at the model's geometry")
    classifier = FactorClassifier(
        classifier_masks(clf_cfg["image_size"], clf_cfg["node"]),
        clf_cfg["node"], clf_cfg["image_size"], device=device)
    load_jax_params(classifier, clf_ckpt["params"])

    dataset = PendulumDataset(image_size=config["image_size"], train=True,
                              seed=config["seed"],
                              n=config.get("n_samples", 10000), device=device,
                              data_dir=config.get("data_dir") or None)
    lower, upper = cdm_matrices(model, classifier, dataset.x_data)

    os.makedirs(args.assets_dir, exist_ok=True)
    names = dataset.name[: config["node"]]
    tag = f"{config['model']}_{config['scm']}_{args.num}"
    write_matrix_csv(f"{args.assets_dir}/lower_{tag}.csv", lower, names)
    write_matrix_csv(f"{args.assets_dir}/upper_{tag}.csv", upper, names)
    viz_heatmap(np.flipud(lower), f"{args.assets_dir}/lower_{tag}.png")
    viz_heatmap(np.flipud(upper), f"{args.assets_dir}/upper_{tag}.png")
    print("CDM(lower):\n", lower.round(3))
    print("CDM(upper):\n", upper.round(3))
    return lower, upper


if __name__ == "__main__":
    main()
