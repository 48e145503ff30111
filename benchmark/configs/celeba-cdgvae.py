"""The CelebA CDG-VAE's cells, set up as ``cdgvae_torch.cli.celeba_main``
sets up its training at its defaults, and driven by its runner.

Set-up: ``float32_and_repeatable`` (no TF32 in matmuls or convolutions,
cuDNN's deterministic algorithms), the CLI's seeding, the corpus (faces
the benchmark makes on the device from the seed: CelebA is not in the
repository), the factory's model with the benchmark's weights copied in,
the packed layout and the capturable Adam over it. The window:
``train.loop.run_epochs`` with the CLI's ``post_update`` (every
spectral-norm site's power iteration) and ``graph_noise`` (a ``partial``
of ``NoisePlan`` in the traffic's dtype): one CUDA graph a step.
"""
from __future__ import annotations

import math
from functools import partial
from pathlib import Path

import torch

from benchmark import plain, products
from benchmark.manifest import load_module
from benchmark.program import load_weights

REF = load_module(Path(__file__).with_suffix(".reference.py"))


def faces(n: int, size: int, seed: int, device):
    """``n`` face-like scenes of ``size`` px and their six attributes, on
    ``device`` from ``seed`` (the geometry of the program's synthetic
    CelebA, drawn in bulk): x [n, S, S, 8] (RGB in [0, 1], then the five
    part masks), y [n, 6] in {0, 1}."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randint(0, 2, (n, 6), generator=g, device=device).float()
    smile, male, cheek, mouth, chubby, eyes = (y[:, i, None, None]
                                               for i in range(6))
    ax = (torch.arange(size, device=device, dtype=torch.float64) / size)
    yy, xx = ax[None, :, None], ax[None, None, :]
    w = 0.30 + 0.08 * chubby
    face = ((xx - 0.5) ** 2 / w ** 2 + (yy - 0.5) ** 2 / 0.16) < 1
    tone = torch.where(male[..., None] < 0.5,
                       torch.tensor([0.9, 0.7, 0.6], device=device),
                       torch.tensor([0.75, 0.55, 0.45], device=device))
    img = torch.full((n, size, size, 3), 0.8, device=device)
    img = torch.where(face[..., None], tone, img)
    cy, cr = 0.52 - 0.04 * cheek, 0.035 + 0.025 * cheek
    cheeks = ((((xx - 0.36) ** 2 + (yy - cy) ** 2) < cr ** 2)
              | (((xx - 0.64) ** 2 + (yy - cy) ** 2) < cr ** 2)) & face
    rosy = torch.where(cheek[..., None] > 0.5,
                       torch.tensor([0.95, 0.45, 0.45], device=device),
                       tone * 0.94)
    img = torch.where(cheeks[..., None], rosy, img)
    eye_h = 0.012 + 0.02 * (1 - eyes)
    eye = (((xx - 0.38).abs() < 0.05) | ((xx - 0.62).abs() < 0.05)) \
        & ((yy - 0.42).abs() < eye_h)
    img = torch.where(eye[..., None],
                      torch.tensor([0.1, 0.1, 0.15], device=device), img)
    mouth_h, mw = 0.015 + 0.025 * mouth, 0.10 + 0.05 * smile
    curve = 0.06 * smile * (torch.cos((xx - 0.5) / mw * (math.pi / 2))
                            .clamp(min=0) - 0.5)
    mouth_m = ((xx - 0.5).abs() < mw) & ((yy - (0.70 + curve)).abs()
                                         < mouth_h)
    img = torch.where(mouth_m[..., None],
                      torch.tensor([0.7, 0.2, 0.2], device=device), img)
    hair = (((xx - 0.5) ** 2 / (w + 0.05) ** 2
             + (yy - 0.42) ** 2 / 0.2) < 1) & (yy < 0.34)
    img = torch.where(hair[..., None],
                      torch.tensor([0.25, 0.15, 0.1], device=device), img)
    noise = torch.randn((n, size, size, 3), generator=g, device=device)
    x = torch.cat([(img + 0.02 * noise).clamp(0, 1),
                   torch.stack([face, mouth_m, face, eye, hair], -1)
                   .float()], -1)
    return x.float().contiguous(), y


class Session:
    """One run's program objects; :meth:`drive` runs the CLI's runner."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 observer):
        from cdgvae_torch.cli.celeba_main import (float32_and_repeatable,
                                                  get_args)
        from cdgvae_torch.cli.common import graphed_epochs
        from cdgvae_torch.factory import build_celeba_model
        from cdgvae_torch.ops.packing import Packer
        from cdgvae_torch.train.steps import make_optimizer
        from cdgvae_torch.utils.simulation import set_random_seed

        if traffic["feed"] != "fixed":
            raise ValueError("the CelebA CLI trains on a fixed corpus")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.observer = torch.device(device), observer
        config = vars(get_args([]))
        config.update({k: cfg[k] for k in (
            "node", "latent_dim", "img_size", "batch_size", "lr", "beta",
            "lambda", "conv_dim", "scm", "flow_num", "causal_structure",
            "packed_params", "adjacency_scaling")})
        config.update(seed=seed, epochs=1 << 30, device=str(self.device),
                      bf16=traffic["dtype"] == "bfloat16")
        self.config = config
        float32_and_repeatable()
        set_random_seed(seed)
        self.data = faces(cfg["n_train"], cfg["img_size"], seed,
                          self.device)
        self.model = build_celeba_model(config, device=self.device,
                                        seed=seed)
        self.weights = REF.sn_start(plain.make_weights(
            REF.weight_specs(cfg), seed, self.device))
        load_weights(self.model, self.weights)
        packer = Packer(self.model) if config["packed_params"] else None
        self.graphed = graphed_epochs(config, self.device)
        self.optimizer = make_optimizer(self.model, config["lr"],
                                        packer=packer,
                                        capturable=self.graphed)
        observer.attach(self.model, self.optimizer)

    @property
    def images_per_step(self) -> int:
        return self.cfg["batch_size"]

    @property
    def steps_per_epoch(self) -> int:
        return self.cfg["n_train"] // self.cfg["batch_size"]

    def drive(self, on_epoch) -> None:
        from cdgvae_torch.models.sagan import sn_refresh
        from cdgvae_torch.train.celeba_steps import make_celeba_step
        from cdgvae_torch.train.loop import run_epochs
        from cdgvae_torch.train.scanned import NoisePlan

        c, model = self.config, self.model
        dtype = torch.bfloat16 if c["bf16"] else None
        step = make_celeba_step(model, self.optimizer, c["beta"],
                                c["lambda"], compute_dtype=dtype)
        run_epochs(self.observer.wrap(step, lambda m: m["loss"]),
                   *self.data, seed=c["seed"], epochs=c["epochs"],
                   batch_size=c["batch_size"], on_epoch=on_epoch,
                   post_update=lambda: sn_refresh(model),
                   graph_noise=self.observer.plan(
                       partial(NoisePlan, model, dtype=dtype))
                   if self.graphed else None)

    def release(self) -> None:
        """Drop the program's state; the weights and data stay for the
        reference."""
        self.model = self.optimizer = None

    def reference(self, tf32=False, half_batch=False) -> dict:
        return REF.run(self.cfg, self.traffic, self.seed, self.weights,
                       self.data, self.device, tf32=tf32,
                       half_batch=half_batch)


def products_per_step(cfg: dict, traffic: dict) -> dict:
    """The step's convolutions (``conv``) and its other matrix products
    (``gemm``), as :mod:`benchmark.products` counts them, and their
    operations (``flops``): the frozen trunk's forward once; the head,
    the SEM solve and the five generators forward and backward (a weight's
    gradient always, an input's where the input needs one: every
    generator product's does, the head's input, the trunk's features, does
    not). The spectral-norm sigma products and elementwise work are left
    out."""
    b, s = cfg["batch_size"], cfg["img_size"]
    item = 2 if traffic["dtype"] == "bfloat16" else 4
    node, ld = cfg["node"], cfg["latent_dim"]
    conv = partial(products.conv, item=item)
    gemm = partial(products.gemm, item=item)

    def half(v):
        return -(-v // 2)

    convs, gemms = [], []
    # the trunk, forward only: the 7x7/2 stem, the max-pool, 4 stages
    side = half(s)
    convs += conv(b, side, 7, 3, 64, hw_in=s, backward=False)
    side, cin = half(side), 64
    for li, width in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            hw_in = side
            if li > 0 and bi == 0:
                side = half(side)
            convs += conv(b, side, 3, cin, width, hw_in=hw_in,
                          backward=False)
            convs += conv(b, side, 3, width, width, backward=False)
            if cin != width:
                convs += conv(b, side, 1, cin, width, hw_in=hw_in,
                              backward=False)
            cin = width
    gemms += gemm(b, 512, 2 * node + 2 * ld, dx=False)
    gemms += gemm(b, node, node, dw=False) + gemm(b, node, node, dw=False)
    blocks, attn_after = REF.schedule(cfg)
    for zd in REF.z_dims(cfg):
        gemms += gemm(b, zd, blocks[0][0] * 16)
        side = 4
        for i, (ci, co) in enumerate(blocks):
            side *= 2
            convs += conv(b, side, 3, ci, co) + conv(b, side, 3, co, co) \
                + conv(b, side, 1, ci, co)
            if i == attn_after:
                hw = side * side
                convs += conv(b, side, 1, co, co // 8) * 2 \
                    + conv(b, side, 1, co, co // 2) \
                    + conv(b, side, 1, co // 2, co)
                gemms += gemm(hw, co // 8, hw // 4, batch=b) \
                    + gemm(hw, hw // 4, co // 2, batch=b)
        convs += conv(b, s, 3, blocks[-1][1], 3)
    flops = sum(f for f, _ in convs + gemms)
    return {"conv": convs, "gemm": gemms, "flops": flops}
