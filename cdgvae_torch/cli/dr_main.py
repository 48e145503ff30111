"""DR-family training entry point (port of ``cdgvae_tpu/cli/dr_main.py:
25-249``): node 5, with the spurious background latent wired into every
CDG-VAE decoder block, and lambda 20. The flags are ``cli.main``'s with
those two defaults; the trainer is ``cli.main.train`` on the DR data.

Usage: python -m cdgvae_torch.cli.dr_main --device cuda ...

Trains on the rendered pendulum-DR train split (one render launch with
the background bit), on a PNG tree (``--data_dir``, as ``cli.generate_data
--dgp dr`` writes one), or with ``--online`` on a fresh DR batch every step
(``train/online.py::dr_batch_fn``); ``--eager``, ``--model InfoMax``,
``--resume`` and ``--dp`` as in ``cli.main``. Writes ``metrics.jsonl``, the
recon figure every 10 epochs, and at the end the checkpoint
``<assets_dir>/model_DR_<model>_<scm>`` with ``config["spurious"] =
True``.
"""
from __future__ import annotations

from . import main as pendulum_main
from .common import train_on_mesh


def main(argv=None):
    config = vars(pendulum_main.get_args(argv, node=5, **{"lambda": 20}))
    config["spurious"] = True  # family marker for checkpoint loaders (api.py)
    return train_on_mesh(pendulum_main.train, config)


if __name__ == "__main__":
    main()
