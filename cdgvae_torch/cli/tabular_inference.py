"""Tabular synthetic-data evaluation entry point (port of ``cdgvae_tpu/cli/
tabular_inference.py:23-93``, with ``--device``): PC CPDAGs on the
real, reconstructed and synthetic tables, their SHDs, and ML efficacy.

Usage: python -m cdgvae_torch.cli.tabular_inference --checkpoint DIR
       [--device cuda]

Loads a tabular checkpoint of either package (VAE, CDG-VAE or InfoMax)
and reports SHD (Train), the reconstructions' CPDAG against the real
train data's, SHD (Sample), the synthetic rows' (as many as the train
split), and the baseline and synthetic R² (loan) or F1 (adult, covtype)
on the real test split. Writes them to
``<assets_dir>/inference_<model>_<dataset>.txt``. The means cover the
linear or logistic row alone (the port fits no forest), and the line
``ML efficacy rows`` names the rows each mean averages.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..api import LoadedModel
from ..data.tabular.datasets import DATASET_SPECS, load_tabular
from ..eval.ml_efficacy import classification_eval, regression_eval
from ..eval.tabular_inference import (real_cpdag, reconstruct_dataset,
                                      sample_synthetic, to_frame)
from ..utils.device import resolve_device
from ..utils.pc import cpdag_shd, pc
from ..utils.simulation import set_random_seed
from .common import add_device_arg


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--data_dir", default="./data", type=str)
    parser.add_argument("--assets_dir", default="./assets/tabular", type=str)
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    loaded = LoadedModel.load(args.checkpoint, device=device)
    model, config = loaded.model, loaded.config
    if "dataset" not in config:
        raise SystemExit(f"{args.checkpoint} is not a tabular checkpoint: "
                         "train one with cli.tabular_main")
    set_random_seed(config["seed"])
    dataset = config["dataset"]
    spec = DATASET_SPECS[dataset]

    train = load_tabular(dataset, train=True, data_dir=args.data_dir)
    test = load_tabular(dataset, train=False, data_dir=args.data_dir)
    os.makedirs(args.assets_dir, exist_ok=True)
    results = {}

    G_real = real_cpdag(train.frame, dataset)
    recon = reconstruct_dataset(model, torch.as_tensor(train.x_data,
                                                       device=device),
                                dataset, seed=config["seed"])
    recon_frame = to_frame(recon, train.topology, train.continuous)
    G_recon, _ = pc(recon_frame, alpha=0.05)
    results["SHD (Train)"] = cpdag_shd(G_real, G_recon)
    print(f"SHD (Train): {results['SHD (Train)']}")

    sample = sample_synthetic(model, len(train.x_data), dataset,
                              seed=config["seed"])
    sample_frame = to_frame(sample, train.topology, train.continuous)
    G_sample, _ = pc(sample_frame, alpha=0.05)
    results["SHD (Sample)"] = cpdag_shd(G_real, G_sample)
    print(f"SHD (Sample): {results['SHD (Sample)']}")

    if spec["task"] == "regression":
        name, evaluate = "R^2", regression_eval
    else:
        name, evaluate = "F1", classification_eval
    base = evaluate(train.frame, test.frame, train.continuous, spec["target"])
    synth = evaluate(sample_frame, test.frame, train.continuous,
                     spec["target"])
    results[f"{name} (Baseline)"] = float(np.mean([v for _, v in base]))
    results[f"{name} (Synthetic)"] = float(np.mean([v for _, v in synth]))
    results["ML efficacy rows"] = ", ".join(n for n, _ in base)
    print(f"{name} (Baseline) {results[f'{name} (Baseline)']:.4f} and "
          f"(Synthetic) {results[f'{name} (Synthetic)']:.4f}: means of the "
          f"rows {results['ML efficacy rows']}")

    with open(os.path.join(
            args.assets_dir,
            f"inference_{config['model']}_{dataset}.txt"), "w") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
    print(results)
    return results


if __name__ == "__main__":
    main()
