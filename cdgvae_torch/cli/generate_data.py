"""Offline dataset generator in the reference's file layout (port of
``cdgvae_tpu/cli/generate_data.py:24-64``).

Samples the chosen DGP, renders it on the device (on CUDA through the
render kernel, a chunk of up to 2,048 images a launch) and writes
``<out>/{train,test}/a_<labels...>.png``, the labels in the file name to 4
decimals, as the reference's generator scripts do.

Usage::

    python -m cdgvae_torch.cli.generate_data --dgp real --out causal_data/pendulum_real
    python -m cdgvae_torch.cli.generate_data --dgp dr   --out causal_data/pendulum_DR
    python -m cdgvae_torch.cli.generate_data --dgp grid --out causal_data/pendulum
"""
import argparse

import numpy as np

from .common import add_device_arg


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dgp", default="real",
                        choices=["grid", "real", "dr"],
                        help="grid = modules/pendulum.py, real = "
                             "modules/pendulum_real.py, dr = "
                             "DR/modules/pendulum_DR.py")
    parser.add_argument("--out", required=True,
                        help="output root; train/ and test/ are created")
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--n", default=10000, type=int,
                        help="samples for real/dr; per-axis grid size for "
                             "grid is fixed at 100 (reference)")
    parser.add_argument("--image_size", default=96, type=int,
                        help="96 matches the reference's 1in x 96dpi PNGs")
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from ..data.png_io import save_png_dataset

    background_col = None
    if args.dgp == "grid":
        from ..data.pendulum import grid_factors
        factors, is_test = grid_factors()
    elif args.dgp == "real":
        from ..data.pendulum import sample_factors_real
        factors, is_test = sample_factors_real(args.seed, args.n)
    else:
        from ..data.pendulum_dr import sample_factors_dr
        train_f, test_f = sample_factors_dr(args.seed, args.n)
        factors = np.concatenate([train_f, test_f], axis=0)
        is_test = np.arange(len(factors)) >= len(train_f)
        background_col = 4

    n_train, n_test = save_png_dataset(
        args.out, factors, is_test, image_size=args.image_size,
        background_col=background_col, device=args.device)
    print(f"wrote {n_train} train / {n_test} test PNGs to {args.out}")
    return n_train, n_test


if __name__ == "__main__":
    main()
