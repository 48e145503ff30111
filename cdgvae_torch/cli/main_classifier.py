"""Train the masked per-node factor classifier of the CDM metric (port of
``cdgvae_tpu/cli/main_classifier.py:1-103``, same flags and defaults, plus
``--device``).

Usage: python -m cdgvae_torch.cli.main_classifier --device cuda ...

Masks: light, angle, shadow, shadow (both shadow factors share the bottom
band). One eager epoch loop with the numpy shuffle, the last batch kept,
the alignment BCE and Adam; prints one ``[epoch NNN]`` line per epoch and
saves ``<assets_dir>/CDMClassifier`` in the JAX package's layout. As in
the reference, the dataset is the full train split, rendered or read
from ``--data_dir``: ``--labeled_ratio`` and ``--label_normalization``
are taken and not used, and so is ``--dp`` (the JAX CLI takes it with
the other infrastructure flags and never builds a mesh): it trains on
one device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.pendulum import PendulumDataset
from ..models.classifier import FactorClassifier
from ..models.vae import pendulum_masks
from ..ops.losses import alignment_bce
from ..train.loop import format_epoch, train_epoch
from ..train.steps import make_optimizer, step_from_loss
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.interop import export_opt_state, export_params
from ..utils.logging import MetricLogger
from ..utils.profiling import trace
from ..utils.simulation import set_random_seed
from .common import add_infra_args, add_png_data_dir_arg, arg_as_bool


def classifier_masks(image_size: int = 64, node: int = 4) -> np.ndarray:
    """The three pendulum bands, the last repeated up to ``node`` masks."""
    m3 = pendulum_masks(image_size, k=3)
    return np.concatenate([m3, np.repeat(m3[-1:], node - 3, axis=0)], axis=0)


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--node", default=4, type=int)
    parser.add_argument("--image_size", default=64, type=int)
    parser.add_argument("--labeled_ratio", default=1, type=float)
    parser.add_argument("--label_normalization", default=True,
                        type=arg_as_bool)
    parser.add_argument("--epochs", default=50, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--lr", default=0.001, type=float)
    add_png_data_dir_arg(parser)
    add_infra_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    config = vars(get_args(argv))
    device = resolve_device(config["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    set_random_seed(config["seed"])
    logger = MetricLogger(logdir=config["assets_dir"],
                          use_wandb=config["wandb"], tags=["Classifier"],
                          config=config)
    dataset = PendulumDataset(image_size=config["image_size"], train=True,
                              seed=config["seed"], n=config["n_samples"],
                              device=device,
                              data_dir=config.get("data_dir") or None)
    node = config["node"]
    clf = FactorClassifier(classifier_masks(config["image_size"], node), node,
                           config["image_size"], generator=torch.Generator(
                               ).manual_seed(config["seed"]), device=device)
    opt = make_optimizer(clf, config["lr"])

    def loss_fn(x, y, generator=None):  # deterministic: no draws
        loss = alignment_bce(clf(x), y[:, :node])
        return loss, {"loss": loss}

    step = step_from_loss(loss_fn, opt)
    shuffle_rng = np.random.default_rng(config["seed"])
    os.makedirs(config["assets_dir"], exist_ok=True)
    with trace(config["profile"]):
        for epoch in range(config["epochs"]):
            metrics = train_epoch(step, dataset.x_data, dataset.y_data,
                                  config["batch_size"], None, shuffle_rng)
            print(format_epoch(epoch, metrics), flush=True)
            logger.log(metrics, step=epoch)

    ckpt = os.path.join(config["assets_dir"], "CDMClassifier")
    save_checkpoint(ckpt, export_params(clf),
                    opt_state=export_opt_state(opt, clf),
                    step=config["epochs"], config=config)
    print(f"checkpoint saved to {ckpt}")
    logger.finish()
    return clf


if __name__ == "__main__":
    main()
