"""Pendulum training entry point, the supervised VAE/CDGVAE path of
``cdgvae_tpu/cli/main.py`` with the same flag names and defaults, plus
``--device``.

Usage: python -m cdgvae_torch.cli.main --model CDGVAE --device cuda ...

Trains on the rendered pendulum_real train split and prints one
``[epoch NNN]`` line per epoch. Checkpoints, figures and the metric logger
are not ported yet.
"""
from __future__ import annotations

import argparse
import ast

import torch

from ..data.pendulum import PendulumDataset
from ..factory import build_pendulum_model
from ..train.loop import format_epoch, run_epochs
from ..train.steps import make_optimizer, make_train_step
from ..utils.device import resolve_device
from ..utils.simulation import set_random_seed


def arg_as_list(s: str):
    """Parse a Python-literal list flag."""
    v = ast.literal_eval(s)
    if type(v) is not list:
        raise argparse.ArgumentTypeError(f'Argument "{s}" is not a list')
    return v


def arg_as_bool(s):
    """Boolean flag parser that makes '--flag False' mean False."""
    if isinstance(s, bool):
        return s
    v = s.strip().lower()
    if v in ("true", "1", "yes", "y"):
        return True
    if v in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f'expected a boolean, got "{s}"')


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--seed", type=int, default=1,
                        help="seed for repeatable results")
    parser.add_argument("--model", type=str, default="CDGVAE",
                        help="VAE based model options: VAE, CDGVAE")
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
    parser.add_argument("--beta", default=0.1, type=float,
                        help="observation noise")
    parser.add_argument("--lambda", default=5, type=float,
                        help="weight of label alignment loss")
    parser.add_argument("--free_bits", default=0.0, type=float,
                        help="floor the per-dim KL at this many nats "
                             "(0 = the reference objective)")
    parser.add_argument("--n_samples", default=10000, type=int,
                        help="DGP sample count (10000 = reference; smaller "
                             "for smoke tests)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    config = vars(get_args(argv))
    if config["model"] not in ("VAE", "CDGVAE"):
        raise SystemExit(f"--model {config['model']} is not ported yet; "
                         "this entry point trains VAE or CDGVAE")
    device = resolve_device(config["device"])
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    set_random_seed(config["seed"])

    dataset = PendulumDataset(
        image_size=config["image_size"], train=True,
        label_normalization=config["label_normalization"],
        seed=config["seed"], n=config["n_samples"], device=device)
    model, _ = build_pendulum_model(config, device=device,
                                    seed=config["seed"])
    optimizer = make_optimizer(model, config["lr"])
    step = make_train_step(model, optimizer, config["beta"],
                           config["lambda"], free_bits=config["free_bits"])
    generator = torch.Generator(device=device).manual_seed(config["seed"])
    return run_epochs(step, dataset.x_data, dataset.y_data, generator,
                      epochs=config["epochs"],
                      batch_size=config["batch_size"],
                      on_epoch=lambda e, m: print(format_epoch(e, m),
                                                  flush=True))


if __name__ == "__main__":
    main()
