"""Causal-structure check of a tabular dataset (port of ``cdgvae_tpu/cli/
dag_discovery.py:17-65``): PC on the raw columns and on the interleaved
labels, to justify the chain topology, with the reference's test per
dataset (chisq for loan and adult, fisherz for covtype). Prints both
CPDAGs and writes their drawings ``dag_raw_<dataset>.png`` and
``dag_labels_<dataset>.png`` (plain PNGs, ``utils/viz.py::viz_graph``).

Usage: python -m cdgvae_torch.cli.dag_discovery --dataset loan

Host-only numpy (scipy for the p-values); no device is used.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.tabular.datasets import load_tabular
from ..utils.pc import pc
from ..utils.viz import viz_graph


def graph_to_binary(G: np.ndarray) -> np.ndarray:
    """causallearn CPDAG encoding -> binary directed adjacency (undirected
    edges kept in both directions)."""
    d = G.shape[0]
    A = np.zeros((d, d))
    for i in range(d):
        for j in range(d):
            if G[i, j] == -1 and G[j, i] == 1:
                A[i, j] = 1
            elif G[i, j] == -1 and G[j, i] == -1:
                A[i, j] = A[j, i] = 1
    return A


def main(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--dataset", type=str, default="loan",
                        help="loan, adult, covtype")
    parser.add_argument("--data_dir", default="./data", type=str)
    parser.add_argument("--alpha", default=0.05, type=float)
    parser.add_argument("--assets_dir", default="./assets/dag", type=str)
    args = parser.parse_args(argv)

    data = load_tabular(args.dataset, train=True, data_dir=args.data_dir)
    os.makedirs(args.assets_dir, exist_ok=True)
    i_test = "fisherz" if args.dataset == "covtype" else "chisq"

    G_raw, _ = pc(data.frame, alpha=args.alpha, indep_test=i_test)
    print(f"CPDAG on raw {args.dataset} columns "
          f"({data.continuous}):\n{G_raw}")
    viz_graph(graph_to_binary(G_raw), data.continuous,
              f"{args.assets_dir}/dag_raw_{args.dataset}.png")

    G_label, _ = pc(data.label, alpha=args.alpha, indep_test=i_test)
    names = [f"u{i + 1}" for i in range(data.label.shape[1])]
    print(f"CPDAG on interleaved labels:\n{G_label}")
    viz_graph(graph_to_binary(G_label), names,
              f"{args.assets_dir}/dag_labels_{args.dataset}.png")
    return G_raw, G_label


if __name__ == "__main__":
    main()
