"""Semi-supervised DR training (port of ``cdgvae_tpu/cli/dr_main_semi.py:
25-157``): the ELBO on the unlabeled DR stream and the alignment on its
first ``--labeled_ratio`` share, with the spurious background latent wired
into every decoder block. The flags are ``cli.main_semi``'s with node 5;
the other defaults are the same (CDGVAEsemi, nonlinear, labeled 10%,
lambda 5: the reference's DR semi default, unlike ``dr_main``'s 20). The
trainer is ``cli.main_semi.train`` on the DR data.

Usage: python -m cdgvae_torch.cli.dr_main_semi --device cuda ...

The fixed two-stream trainer, ``--eager``, ``--online`` (the unlabeled
stream from ``train/online.py::dr_batch_fn``), ``--resume`` and ``--dp``.
Writes ``metrics.jsonl`` and at the end the checkpoint
``<assets_dir>/model_DR_<model>_<scm>`` with ``config["spurious"] =
True``.
"""
from __future__ import annotations

from . import main_semi
from .common import train_on_mesh


def main(argv=None):
    config = vars(main_semi.get_args(argv, node=5))
    config["spurious"] = True  # family marker for checkpoint loaders (api.py)
    return train_on_mesh(main_semi.train, config,
                         extra_batch_sizes=(config["batch_sizeL"],))


if __name__ == "__main__":
    main()
