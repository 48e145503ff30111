#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. the build of every CUDA kernel of the main path, timed, with the
   compiler's report (registers, shared memory, spills, stack frame);
3. each kernel against its plain torch version on the card, at the shapes
   the main path gives it, at ragged sizes, at edge factors and at 16,
   128 and 512 px;
4. the main path: ``PendulumDataset`` rendered through the kernel (build
   time on the host clock), then the full-width flagship CDG-VAE trained
   for 3 epochs of 29 steps; the loss must be finite and fall, and every
   kernel must have launched;
5. the full-width model's loss on the card against the same model on the
   CPU (same weights, batch and noise);
6. times on the card from CUDA events, beside each kernel's bound;
7. a torch.profiler window over 10 train steps (device busy share, time by
   kernel) and over render launches (device time without host overhead).

The last two lines are a ``{"kernels": [...]}`` JSON object and the
``{"ok": true, ...}`` JSON object. Without a CUDA device, or without the
repository beside it, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations a pixel of the uncut function, every shape evaluated
# at every pixel as render_reference does: pixel centre 2, window 13,
# background 1, sun 21, rod 39, ball 16, shadow 41, the five paints on 3
# channels 50, the [-1, 1] map 6. csrc/render.cu skips the shapes on the
# tiles their boxes miss and does far fewer; the bound still counts these,
# and is set by the bytes either way.
RENDER_OPS_PER_PIXEL = 189

FLAGSHIP = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                inverse_loop=100, factor=[1, 1, 2], image_size=64,
                adjacency_scaling=True)
BATCH, BETA, LAM, LR, EPOCHS = 128, 0.1, 5.0, 1e-3, 3
N_SAMPLES = 4949  # its train split is 3,712 images = 29 batches of 128
MAX_ABS_TOL, MEAN_ABS_TOL = 5e-5, 1e-6
# at 512 px (renderer_cuda.MAX_SIZE) max |d| read 6.7e-5 on the case below
# and 1.0e-4 on tests/test_torch_kernels.py's factors (H100); twice the
# larger
MAX_ABS_TOL_512 = 2e-4


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profile_window(fn) -> tuple[float, float, str]:
    """Run ``fn`` once warm and once under torch.profiler. Returns (device
    kernel time s, wall time s, top-kernel table)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: a GPU user annotation (Optimizer.step#...) spans
    # kernels that are listed on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-6
    kernels.sort(key=lambda e: -e.self_device_time_total)
    table = "\n".join(
        f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
        f"{e.key[:90]}" for e in kernels[:12])
    return busy, wall, table


def render_bound_ms(n: int, size: int, background: bool) -> tuple[float, str]:
    """Least time for the render: each input read once, the output written
    once, against the float32 operations it must do."""
    nbytes = n * 4 * 4 + (n * 4 if background else 0) + n * size * size * 3 * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n * size * size * RENDER_OPS_PER_PIXEL / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "cdgvae_torch" / "csrc").is_dir():
        print(f"chip_smoke: no cdgvae_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cdgvae_torch.data.pendulum import PendulumDataset, sample_factors_real
    from cdgvae_torch.factory import build_pendulum_model
    from cdgvae_torch.ops import _build, renderer_cuda
    from cdgvae_torch.ops.renderer import render_reference
    from cdgvae_torch.train.loop import format_epoch, run_epochs
    from cdgvae_torch.train.scanned import (epoch_batches,
                                            make_supervised_loss_fn)
    from cdgvae_torch.train.steps import make_optimizer, make_train_step

    dev = torch.device("cuda")

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("render", ["render.cu"])
    print(f"build render.cu: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    print("ptxas report (registers, shared memory, spills, stack frame):")
    print(lib.with_suffix(".log").read_text().strip())

    # 3. kernel against plain version on the card
    factors_np, is_test = sample_factors_real(seed=1, n=N_SAMPLES)
    f_all = torch.as_tensor(factors_np[~is_test, :4], dtype=torch.float32,
                            device=dev)
    check(f_all.shape[0] == 3712, f"train split is {f_all.shape[0]}")
    rng = np.random.default_rng(0)
    bg_all = torch.as_tensor(rng.integers(0, 2, 3712).astype(np.float32),
                             device=dev)
    # xi1 in {pi/4, pi/2}, xi2 in {0, pi/4}, xi3, xi4 in {0, 13.5}
    edge = torch.as_tensor(np.stack([g.ravel() for g in np.meshgrid(
        [math.pi / 4, math.pi / 2], [0.0, math.pi / 4], [0.0, 13.5],
        [0.0, 13.5], indexing="ij")], 1), dtype=torch.float32, device=dev)
    cases = [("B=3712", f_all, None, 64), ("B=3712 bg", f_all, bg_all, 64),
             ("B=2048", f_all[:2048], None, 64),
             ("B=133 (ragged last wave)", f_all[:133], None, 64),
             ("B=13 bg", f_all[:13], bg_all[:13], 64),
             ("B=1", f_all[:1], None, 64),
             ("B=3712 16px bg", f_all, bg_all, 16),
             ("B=512 128px", f_all[:512], None, 128),
             ("edge", edge, None, 64), ("edge bg", edge, bg_all[:16], 64),
             ("edge 16px", edge, None, 16), ("edge 128px", edge, None, 128),
             ("B=2 512px", f_all[:2], None, 512)]
    max_err = 0.0
    for name, f, bg, size in cases:
        ref = render_reference(f, size, bg)
        out = renderer_cuda.render_cuda(f, size, bg)
        torch.cuda.synchronize()
        check(out.shape == (f.shape[0], size, size, 3),
              f"{name}: shape {out.shape}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out - ref).abs()
        mx, mean = diff.max().item(), diff.mean().item()
        print(f"render {name}: max|d| {mx:.3e} mean|d| {mean:.3e}")
        tol = MAX_ABS_TOL if size <= 128 else MAX_ABS_TOL_512
        check(mx <= tol and mean <= MEAN_ABS_TOL,
              f"render {name} disagrees with render_reference "
              f"(max {mx}, mean {mean})")
        if size <= 128:  # the kernels line: the cases held to MAX_ABS_TOL
            max_err = max(max_err, mx)

    # 4. the main path, with the launch counts read around it
    renderer_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dataset = PendulumDataset(n=N_SAMPLES, device=dev)
    torch.cuda.synchronize()
    print(f"dataset build ({len(dataset)} train images, DGP + render): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock) [{card}]")
    model, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
    optimizer = make_optimizer(model, LR)
    step = make_train_step(model, optimizer, BETA, LAM)
    generator = torch.Generator(device=dev).manual_seed(1)
    stamps = [time.perf_counter()]

    def on_epoch(epoch, metrics):
        stamps.append(time.perf_counter())
        print(format_epoch(epoch, metrics), flush=True)

    history = run_epochs(step, dataset.x_data, dataset.y_data, generator,
                         epochs=EPOCHS, batch_size=BATCH, on_epoch=on_epoch)
    torch.cuda.synchronize()
    launches = {"render": renderer_cuda.launches}
    print(f"main path launches: {launches}")
    check(len(dataset) == 3712, f"dataset has {len(dataset)} images")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    losses = [m["loss"] for m in history]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    steps = len(dataset) // BATCH
    train_imgs_s = steps * BATCH / (stamps[-1] - stamps[-2])
    print(f"train: {steps} steps/epoch, last epoch "
          f"{stamps[-1] - stamps[-2]:.4f} s = {train_imgs_s:.1f} imgs/s "
          f"(host clock, [{card}])")

    # 5. the full-width model on the card against the CPU
    batch = dataset.x_data[:BATCH]
    labels = dataset.y_data[:BATCH]
    noise = torch.as_tensor(rng.standard_normal((BATCH, 4)),
                            dtype=torch.float32)
    result = {}
    for d in ("cpu", "cuda"):
        m, _ = build_pendulum_model(FLAGSHIP, device=d, seed=0)
        loss, _ = make_supervised_loss_fn(m, BETA, LAM)(
            batch.to(d), labels.to(d), noise=noise.to(d))
        result[d] = loss.item()
    rel = abs(result["cuda"] - result["cpu"]) / abs(result["cpu"])
    print(f"full-width loss cuda {result['cuda']:.6f} cpu "
          f"{result['cpu']:.6f} rel {rel:.2e}")
    check(rel <= 1e-5, "full-width loss on the card disagrees with the CPU")

    # 6. times on the card
    rows = {}
    for n in (3712, 2048, 128):
        f = f_all[:n]
        k_ms = time_ms(lambda: renderer_cuda.render_cuda(f, 64))
        p_ms = time_ms(lambda: render_reference(f, 64), reps=5)
        b_ms, b_by = render_bound_ms(n, 64, background=False)
        rows[n] = (k_ms, p_ms, b_ms, b_by)
        print(f"render B={n}: kernel {k_ms * 1e3:.2f} us, plain "
              f"{p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}) "
              f"[{card}]")
    k_ms, p_ms, b_ms, b_by = rows[3712]

    # 7. a profiled window: device busy share of the train step and its
    # kernels, and the render kernel's device time without host overhead
    order = epoch_batches(len(dataset), BATCH, generator)[:10]
    busy, wall, table = profile_window(
        lambda: [step(dataset.x_data[i], dataset.y_data[i],
                      generator=generator) for i in order])
    if busy > 0:
        step_s = (stamps[-1] - stamps[-2]) / steps  # unprofiled, epoch 3
        print(f"train step, profiled {len(order)} steps: device busy "
              f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall; per step "
              f"{busy / len(order) * 1e3:.3f} ms busy of "
              f"{step_s * 1e3:.3f} ms unprofiled = "
              f"{busy / len(order) / step_s:.3f} busy share [{card}]")
        print(table)
        for n in (3712, 2048, 128):
            f = f_all[:n]
            out = torch.empty((n, 64, 64, 3), device=dev)
            busy, wall, _ = profile_window(
                lambda: [renderer_cuda.render_cuda(f, 64, out=out)
                         for _ in range(20)])
            print(f"render B={n} device time (profiler): "
                  f"{busy / 20 * 1e6:.2f} us per launch, "
                  f"{wall / 20 * 1e6:.2f} us wall per call; events "
                  f"{rows[n][0] * 1e3:.2f} us [{card}]")
    else:
        print("profiler saw no device kernels: busy share not measured")

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "render", "route": "cuda",
        "source": "cdgvae_torch/csrc/render.cu",
        "replaces": "cdgvae_tpu/ops/renderer_pallas.py:146",
        "launches": launches["render"], "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
