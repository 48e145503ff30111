"""cuDNN's deterministic algorithms on the CelebA trainer: what they cost a
step, and whether a resumed run equals the uninterrupted one.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.celeba_determinism [--work DIR]

At ``cli.celeba_main``'s defaults (batch 16, 128 px, conv_dim 32, trunk
frozen, packed parameters; its 64 synthetic faces, 4 steps an epoch), with
``torch.backends.cudnn.deterministic`` off (PyTorch's default) and on
(what ``celeba_main.float32_and_repeatable`` sets), each for the float32
and the bfloat16 step, it prints:

- host ms a step over whole epochs of 4 steps, 5 epochs a call, the four
  paths in turn for 3 rounds after a warm one (the median);
- kernels a step and device busy ms a step over 4 profiled steps;
- ``celeba_main --resume`` from a 2-epoch checkpoint to epoch 3 against
  an uninterrupted 3-epoch run: the largest |d| over the params and the
  number of elements that differ.

TF32 is off throughout. The "off" runs of ``celeba_main`` replace its
``float32_and_repeatable`` with the TF32 switches alone. The last line is
the results as one JSON object. ``--work`` (default ``build/
celeba_determinism``, git-ignored) holds the runs' checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import statistics
import subprocess
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from ..cli import celeba_main
from ..data.celeba import synthetic_celeba
from ..factory import build_celeba_model
from ..models.sagan import sn_refresh
from ..ops.packing import Packer
from ..train.celeba_steps import make_celeba_step
from ..train.scanned import epoch_batches
from ..train.steps import make_optimizer
from ..utils.checkpoint import load_checkpoint

MODES = {"off": False, "on": True}
DTYPES = {"f32": None, "bf16": torch.bfloat16}
EPOCHS_A_CALL, PROFILED_STEPS = 5, 4


def _set_mode(deterministic: bool):
    """TF32 off, no autotuning, cuDNN's deterministic algorithms on or
    off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False


def step_costs(config: dict, dev: torch.device) -> dict:
    """Host ms, kernels and device busy ms a step of each (mode, dtype)."""
    from torch.profiler import ProfilerActivity, profile

    x_np, y_np = synthetic_celeba(64, config["img_size"],
                                  seed=config["seed"])
    x, y = (torch.as_tensor(a, device=dev) for a in (x_np, y_np))
    bs = config["batch_size"]
    steps_an_epoch = len(x) // bs
    paths = {}
    for mode in MODES:
        for dname, dtype in DTYPES.items():
            m = build_celeba_model(config, device=dev, seed=0)
            opt = make_optimizer(m, config["lr"], packer=Packer(m))
            paths[f"{dname} {mode}"] = (mode, m, make_celeba_step(
                m, opt, config["beta"], config["lambda"],
                compute_dtype=dtype))

    def epochs(name, k, n=EPOCHS_A_CALL):
        mode, m, step = paths[name]
        _set_mode(MODES[mode])
        gen = torch.Generator(device=dev).manual_seed(1000 + k)
        for _ in range(n):
            for idx in epoch_batches(len(x), bs, gen):
                step(x[idx], y[idx], generator=gen)
                sn_refresh(m)
        torch.cuda.synchronize()

    per_step = {name: [] for name in paths}
    for k in range(4):  # round 0 warms (and lets cuDNN pick)
        for name in paths:
            t0 = time.perf_counter()
            epochs(name, k)
            if k:
                per_step[name].append((time.perf_counter() - t0)
                                      / (EPOCHS_A_CALL * steps_an_epoch))
    out = {}
    for name, (mode, m, step) in paths.items():
        _set_mode(MODES[mode])
        gen = torch.Generator(device=dev).manual_seed(77)
        order = epoch_batches(len(x), bs, gen)[:PROFILED_STEPS]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for idx in order:
                step(x[idx], y[idx], generator=gen)
                sn_refresh(m)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        out[name] = {
            "host_ms": [s * 1e3 for s in per_step[name]],
            "host_ms_median": statistics.median(per_step[name]) * 1e3,
            "kernels_a_step": sum(e.count for e in kernels)
            / PROFILED_STEPS,
            "busy_ms_a_step": sum(e.self_device_time_total for e in kernels)
            / 1e3 / PROFILED_STEPS}
    _set_mode(False)
    return out


def _cli(args: list[str], deterministic: bool):
    """``celeba_main`` in this process, its output dropped; with
    ``deterministic`` False its switches are the TF32 ones alone."""
    patch = contextlib.nullcontext() if deterministic else \
        mock.patch.object(celeba_main, "float32_and_repeatable",
                          lambda: _set_mode(False))
    with patch, contextlib.redirect_stdout(io.StringIO()):
        celeba_main.main(args)
    torch.cuda.synchronize()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


def resume_drift(work: Path) -> dict:
    """For each (mode, dtype): ``--resume`` from epoch 2 to 3 against an
    uninterrupted 3-epoch run, max |d| over the params and the count of
    elements that differ."""
    out = {}
    for mode, deterministic in MODES.items():
        for dname in DTYPES:
            base = ["--device", "cuda"] + (["--bf16"] if dname == "bf16"
                                           else [])
            part, full = work / f"{dname}_{mode}_part", \
                work / f"{dname}_{mode}_full"
            for d in (part, full):
                shutil.rmtree(d, ignore_errors=True)
            ck = part / "celeba_CDGVAE_linear"
            t0 = time.perf_counter()
            _cli(base + ["--epochs", "2", "--ckpt_every", "1",
                         "--assets_dir", str(part)], deterministic)
            _cli(base + ["--epochs", "3", "--resume", str(ck),
                         "--assets_dir", str(part)], deterministic)
            _cli(base + ["--epochs", "3", "--assets_dir", str(full)],
                 deterministic)
            a = dict(_flat(load_checkpoint(str(ck))["params"]))
            b = dict(_flat(load_checkpoint(
                str(full / "celeba_CDGVAE_linear"))["params"]))
            if a.keys() != b.keys():
                raise RuntimeError(f"{dname} {mode}: the checkpoints' "
                                   "params differ in layout")
            diff = {n: np.abs(a[n].astype(np.float64)
                              - b[n].astype(np.float64)) for n in a}
            worst = max(diff, key=lambda n: diff[n].max())
            out[f"{dname} {mode}"] = {
                "max_abs": float(diff[worst].max()),
                "worst_param": worst,
                "elements_differing": int(sum((d > 0).sum()
                                              for d in diff.values())),
                "elements": int(sum(d.size for d in diff.values())),
                "seconds": time.perf_counter() - t0}
    _set_mode(False)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default="build/celeba_determinism")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("celeba_determinism needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    config = vars(celeba_main.get_args([]))
    dev = torch.device("cuda")
    costs = step_costs(config, dev)
    for name, c in costs.items():
        print(f"CelebA {name} (cuDNN deterministic {name.split()[1]}): host "
              f"{c['host_ms_median']:.3f} ms a step (rounds "
              f"{', '.join(f'{v:.3f}' for v in c['host_ms'])}), "
              f"{c['kernels_a_step']:.0f} kernels a step, device busy "
              f"{c['busy_ms_a_step']:.3f} ms a step [{card}]", flush=True)
    drift = resume_drift(work)
    for name, d in drift.items():
        print(f"CelebA {name}: --resume 2 -> 3 against 3 epochs: params max "
              f"|d| {d['max_abs']:.3e} ({d['worst_param']}), "
              f"{d['elements_differing']:,} of {d['elements']:,} elements "
              f"differ; {d['seconds']:.1f} s [{card}]", flush=True)
    print(json.dumps({"card": card, "steps": costs, "resume": drift}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
