"""The pendulum CDG-VAE's cells, set up as ``cdgvae_torch.cli.main``
sets up its training, and driven by the CLI's own runners.

Set-up: the CLI's precision switch (no TF32 in matmuls), its seeding, the
rendered dataset (``PendulumDataset``: the numpy DGP and one launch of the
render kernel) for the fixed feed, the factory's model with the
benchmark's weights copied in, the capturable Adam. The window: for the
``fixed`` feed ``run_scanned_training`` (``train.loop.run_epochs``,
graphed: one CUDA graph a step over the resident dataset); for the
``online`` feed ``run_online_training`` (``make_online_run_from_loss``:
each step draws its factors on the device and renders its batch inside
the graph). Both get the CLI's ``graph_noise``, a ``partial`` of
``NoisePlan``.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

import torch

from benchmark import plain, products
from benchmark.manifest import load_module
from benchmark.program import load_weights

REF = load_module(Path(__file__).with_suffix(".reference.py"))


class Session:
    """One run's program objects; :meth:`drive` runs the CLI's entry."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 observer):
        from cdgvae_torch.cli.common import graphed_epochs
        from cdgvae_torch.cli.main import get_args
        from cdgvae_torch.data.pendulum import PendulumDataset
        from cdgvae_torch.factory import build_pendulum_model
        from cdgvae_torch.train.steps import make_optimizer
        from cdgvae_torch.utils.simulation import set_random_seed

        if traffic["dtype"] != "float32" or traffic["feed"] not in (
                "fixed", "online"):
            raise ValueError("the pendulum CLI trains in float32, on the "
                             "fixed dataset or online")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.observer = torch.device(device), observer
        config = vars(get_args([]))
        config.update({k: cfg[k] for k in (
            "model", "node", "factor", "scm", "flow_num", "image_size",
            "batch_size", "lr", "beta", "lambda", "n_samples",
            "label_normalization", "adjacency_scaling")})
        config.update(seed=seed, epochs=1 << 30, device=str(self.device),
                      online=traffic["feed"] == "online")
        self.config = config
        torch.backends.cuda.matmul.allow_tf32 = False  # as cli.main.train
        set_random_seed(seed)
        if traffic["feed"] == "fixed":
            ds = PendulumDataset(image_size=cfg["image_size"], train=True,
                                 labeled_ratio=1.0,
                                 label_normalization=True, seed=seed,
                                 n=cfg["n_samples"], device=self.device)
            self.data = (ds.x_data, ds.y_data)
        self.model, _ = build_pendulum_model(config, device=self.device,
                                             seed=seed)
        self.weights = plain.make_weights(REF.weight_specs(cfg), seed,
                                          self.device)
        load_weights(self.model, self.weights)
        self.graphed = graphed_epochs(config, self.device)
        self.optimizer = make_optimizer(self.model, config["lr"],
                                        capturable=self.graphed)
        observer.attach(self.model, self.optimizer)

    @property
    def images_per_step(self) -> int:
        return self.cfg["batch_size"]

    @property
    def steps_per_epoch(self) -> int:
        from cdgvae_torch.train.online import train_split_size
        return train_split_size(self.cfg["n_samples"]) \
            // self.cfg["batch_size"]

    def drive(self, on_epoch) -> None:
        from cdgvae_torch.cli.common import (run_online_training,
                                             run_scanned_training)
        from cdgvae_torch.train.online import pendulum_batch_fn
        from cdgvae_torch.train.scanned import (NoisePlan,
                                                make_supervised_loss_fn)
        from cdgvae_torch.train.steps import make_train_step

        c, obs = self.config, self.observer
        graph_noise = obs.plan(partial(NoisePlan, self.model,
                                       marginal=None)) \
            if self.graphed else None
        if c["online"]:
            loss_fn = make_supervised_loss_fn(self.model, c["beta"],
                                              c["lambda"],
                                              free_bits=c["free_bits"])

            def sample_builder(batch_size):
                return pendulum_batch_fn(batch_size, c["image_size"],
                                         norm_seed=c["seed"],
                                         norm_n=c["n_samples"],
                                         device=self.device)

            run_online_training(
                c, loss_fn=obs.wrap(loss_fn, lambda out: out[0]),
                optimizer=self.optimizer, device=self.device, start_epoch=0,
                on_epoch=on_epoch, sample_batch_builder=sample_builder,
                graph_noise=graph_noise)
        else:
            step = make_train_step(self.model, self.optimizer, c["beta"],
                                   c["lambda"], free_bits=c["free_bits"])
            run_scanned_training(c, step=obs.wrap(step, lambda m: m["loss"]),
                                 data=self.data, on_epoch=on_epoch,
                                 graph_noise=graph_noise)

    def release(self) -> None:
        """Drop the program's state; the weights stay for the reference."""
        self.model = self.optimizer = self.data = None

    def reference(self, tf32=False, half_batch=False) -> dict:
        return REF.run(self.cfg, self.traffic, self.seed, self.weights,
                       self.device, tf32=tf32, half_batch=half_batch)


def products_per_step(cfg: dict, traffic: dict) -> dict:
    """The step's matrix products, as :mod:`benchmark.products` counts
    them: ``gemm`` (every one) and ``flops`` (their operations)."""
    b, s, hid, node = (cfg["batch_size"], cfg["image_size"], cfg["hidden"],
                       cfg["node"])
    d, k, kmax = 3 * s * s, len(cfg["factor"]), max(cfg["factor"])
    g = products.gemm
    out = (g(b, d, hid, dx=False)                 # encoder, on the data
           + g(b, hid, hid) + g(b, hid, 2 * node)
           + g(b, node, node, dw=False)           # the SEM solve, eps
           + g(b, node, node, dw=False)           # and the posterior mean
           + g(b, kmax, hid, batch=k) + g(b, hid, hid, batch=k))
    for c0, c1 in REF.bands(s):
        out += g(b, hid, c1 - c0)
    return {"gemm": out, "flops": sum(f for f, _ in out)}
