"""CDG-TVAE synthetic-data evaluation entry point (port of
``cdgvae_tpu/cli/tabular_inference_tvae.py``, with ``--device``): synthetic
rows through the DataTransformer's inverse with the learned sigmas, the PC
CPDAG's SHD against the real train data's, and ML efficacy.

Usage: python -m cdgvae_torch.cli.tabular_inference_tvae --checkpoint DIR
       [--device cuda]

Loads a TVAE checkpoint with its ``transformer.npz`` (``api.LoadedModel``),
draws as many synthetic rows as the train split, z-scores them against
the train table (``eval.tabular_inference.zscore_synthetic``), and
reports SHD (Sample) and the synthetic R² (loan) or F1 (adult, covtype)
on the real test split, with the rows that mean averages. Writes them to
``<assets_dir>/inference_TVAE_<dataset>.txt``.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..api import LoadedModel
from ..data.tabular.datasets import DATASET_SPECS, load_tabular
from ..eval.tabular_inference import (efficacy, real_cpdag,
                                      sample_synthetic_tvae,
                                      zscore_synthetic)
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
    config = loaded.config
    if loaded.transformer is None:
        raise SystemExit(f"{args.checkpoint} is not a TVAE checkpoint: "
                         "train one with cli.tabular_main_tvae")
    set_random_seed(config["seed"])
    dataset = config["dataset"]
    spec = DATASET_SPECS[dataset]

    train = load_tabular(dataset, train=True, data_dir=args.data_dir)
    test = load_tabular(dataset, train=False, data_dir=args.data_dir)
    os.makedirs(args.assets_dir, exist_ok=True)
    results = {}

    # the real table's CPDAG with the reference's test; the sample's with
    # fisherz (its values are continuous)
    G_real = real_cpdag(train.frame, dataset)
    raw = sample_synthetic_tvae(loaded, len(train.x_data),
                                seed=config["seed"])
    sample = zscore_synthetic(raw, train, spec, dataset)
    G_sample, _ = pc(sample, alpha=0.05)
    results["SHD (Sample)"] = cpdag_shd(G_real, G_sample)
    print(f"SHD (Sample): {results['SHD (Sample)']}")

    name = "R^2" if spec["task"] == "regression" else "F1"
    score, rows = efficacy(sample, test.frame, train.continuous, spec)
    results[f"{name} (Synthetic)"] = score
    results["ML efficacy rows"] = ", ".join(rows)
    print(f"{name} (Synthetic) {score:.4f}: the mean of the rows "
          f"{results['ML efficacy rows']}")

    with open(os.path.join(args.assets_dir,
                           f"inference_TVAE_{dataset}.txt"), "w") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
    print(results)
    return results


if __name__ == "__main__":
    main()
