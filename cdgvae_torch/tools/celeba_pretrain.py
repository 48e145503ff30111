"""Pretrain a torchvision-layout ResNet-18 on the synthetic CelebA corpus
(port of ``scripts/celeba_pretrain_torch.py``: the same flags, defaults,
protocol and sidecar keys, plus ``--device``).

The offline stand-in for ImageNet pretraining: supervised classification
of the 6 pixel-visible attributes of ``data/celeba.py::synthetic_celeba``
gives a trunk whose features expose them linearly. ``cli.celeba_main
--torch_weights <out>`` (and the JAX package's importer) load it, freeze
it and train CDG-VAE on top; ``tools/celeba_probe.py`` probes it.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.celeba_pretrain [--n_train 2000]
        [--n_test 256] [--img_size 128] [--epochs 2] [--batch 32]
        [--lr 1e-3] [--seed 0] [--data_seed 1] [--out FILE]
        [--device cuda]

The protocol, step for step as the script's: RGB in [0, 1], NCHW; BCE
with logits on the 6 attributes; Adam at ``--lr``; one ``randperm`` an
epoch and ``ceil(n_train / batch)`` batches, the short last one kept; the
test attribute accuracy in eval mode after each epoch. The script seeds
the global generator, draws the net's init from it and then each epoch's
permutation; this tool draws the same stream from a fork of the global
generator, which the caller gets back untouched, so on the CPU it writes
the script's weights bit for bit. The net is built on the CPU and moved
to the device, so the card starts from the same weights. Float32 without
TF32 and with deterministic cuDNN (``cli.celeba_main``'s switches), so
two runs on the card write the same file byte for byte.

Writes ``<out>`` (``torch.save`` of the state dict, on the CPU; default
``build/celeba_pretrain/celeba_pretrained_resnet18.pt`` under the
checkout) and ``<out>.json``: the script's keys (``test_attr_acc``,
``n_train``, ``img_size``, ``epochs``, ``data_seed``, ``wall_s``), plus
``device`` and ``card`` (``nvidia-smi``'s name and power limit on the
card), the epochs' mean BCE (``bce``), each step's loss (``losses``),
host ms a training step
(``ms_per_step``, the epochs' step loops over their steps; each step
reads its loss back, as the script's does) and the file's ``sha256``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..cli.celeba_main import float32_and_repeatable
from ..data.celeba import synthetic_celeba
from ..models.torchvision_resnet import ResNet18
from ..utils.device import resolve_device
from .cdm_seeds import card_record

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "celeba_pretrain",
                           "celeba_pretrained_resnet18.pt")


def rgb_nchw(x: np.ndarray) -> torch.Tensor:
    """The RGB channels of ``synthetic_celeba``'s [n, S, S, 8] images as
    [n, 3, S, S], the [0, 1] range the downstream encoder consumes."""
    return torch.from_numpy(x[..., :3].transpose(0, 3, 1, 2).copy())


@torch.no_grad()
def test_attr_acc(net, xt: torch.Tensor, yt: torch.Tensor) -> float:
    net.eval()
    return float(((net(xt) > 0) == (yt > 0.5)).float().mean())


def pretrain(*, n_train: int = 2000, n_test: int = 256,
             img_size: int = 128, epochs: int = 2, batch: int = 32,
             lr: float = 1e-3, seed: int = 0, data_seed: int = 1,
             device="cuda"):
    """Pretrain the net by the script's protocol (module docstring);
    returns ``(net on device, record)``, the record holding each step's
    loss (``losses``), each epoch's mean BCE (``bce``), the final
    ``test_attr_acc``, the step loops' host seconds (``train_s``) and
    the script's ``wall_s`` (training and its evaluations)."""
    device = resolve_device(device)
    float32_and_repeatable()
    x, y = synthetic_celeba(n_train, img_size, seed=data_seed)
    xt, yt = synthetic_celeba(n_test, img_size, seed=data_seed + 1)
    x, xt = rgb_nchw(x).to(device), rgb_nchw(xt).to(device)
    y, yt = torch.from_numpy(y).to(device), torch.from_numpy(yt).to(device)

    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        net = ResNet18(n_out=y.shape[1], device=device)
        perms = torch.Generator()
        perms.set_state(torch.get_rng_state())
    opt = torch.optim.Adam(net.parameters(), lr=lr)

    n_steps = math.ceil(len(x) / batch)
    t_start = time.time()
    rec = {"losses": [], "bce": [], "steps": epochs * n_steps,
           "train_s": 0.0}
    for epoch in range(epochs):
        net.train()
        perm = torch.randperm(len(x), generator=perms)
        tot = 0.0
        t0 = time.perf_counter()
        for s in range(n_steps):
            idx = perm[s * batch: (s + 1) * batch].to(device)
            logits = net(x[idx])
            loss = F.binary_cross_entropy_with_logits(logits, y[idx])
            opt.zero_grad()
            loss.backward()
            opt.step()
            rec["losses"].append(loss.item())
            tot += rec["losses"][-1] * len(idx)
        rec["train_s"] += time.perf_counter() - t0
        acc = test_attr_acc(net, xt, yt)
        rec["bce"].append(tot / len(x))
        print(f"[epoch {epoch}] bce {tot / len(x):.4f}  "
              f"test attr-acc {acc:.4f}", flush=True)
    rec["test_attr_acc"] = test_attr_acc(net, xt, yt)
    rec["wall_s"] = time.time() - t_start
    return net, rec


def save(net, out: str) -> str:
    """``torch.save`` the CPU state dict to ``out``; returns its sha256."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, out)
    with open(out, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_train", type=int, default=2000)
    ap.add_argument("--n_test", type=int, default=256)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_seed", type=int, default=1,
                    help="corpus seed; keep equal to the downstream "
                         "study's --data_seed so the pretraining sees the "
                         "same distribution (train split only)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = get_args(argv)
    device = resolve_device(args.device)
    net, rec = pretrain(n_train=args.n_train, n_test=args.n_test,
                        img_size=args.img_size, epochs=args.epochs,
                        batch=args.batch, lr=args.lr, seed=args.seed,
                        data_seed=args.data_seed, device=device)
    digest = save(net, args.out)
    side = {"test_attr_acc": round(rec["test_attr_acc"], 4),
            "n_train": args.n_train, "img_size": args.img_size,
            "epochs": args.epochs, "data_seed": args.data_seed,
            "wall_s": round(rec["wall_s"], 1),
            **card_record(device), "bce": rec["bce"],
            "losses": rec["losses"],
            "ms_per_step": rec["train_s"] / max(rec["steps"], 1) * 1e3,
            "sha256": digest}
    with open(args.out + ".json", "w") as f:
        json.dump(side, f, indent=1)
    print(f"state dict -> {args.out}  {side}")
    return side


if __name__ == "__main__":
    main()
