#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. the card (nvidia-smi name and power limit, torch, CUDA and numpy
   versions);
2. the build of every CUDA kernel of the main path, timed, with the
   compiler's report (registers, shared memory, spills, stack frame);
3. each kernel against its plain torch version on the card, at the shapes
   the main path gives it (the online step's 128 images into a caller's
   buffer among them), at ragged sizes, at edge factors and at 16, 128
   and 512 px;
4. the dataset path: ``PendulumDataset`` rendered through the kernel
   (build time on the host clock), then the full-width flagship CDG-VAE
   trained for 3 epochs of 29 steps; the loss must be finite and fall, and
   every kernel must have launched;
5. the full-width model's loss on the card against the same model on the
   CPU (same weights, batch and noise);
6. times on the card from CUDA events, beside each kernel's bound;
7. a torch.profiler window over 10 train steps (device busy share, time by
   kernel) and over render launches (device time without host overhead);
8. the CLI (``cdgvae_torch.cli.main``) at full width for 2 epochs: the
   checkpoint, metric log and recon figure are written, and ``--resume``
   to 3 epochs continues from epoch 2;
9. serving: ``LoadedModel`` on the card answers encode, reconstruct,
   counterfactual (every node) and generation at batch 1, 7 and 128, each
   held against the same checkpoint served on the CPU, with the ms per
   request from CUDA events;
10. the online trainer through the CLI (``--online``, 2 epoch-equivalents
    of 29 steps of 128): the loss is finite and falls, the render kernel
    launches at least once a step; the online batch function's images
    against ``render_reference`` of the same draw; host time a step over
    whole epochs of the online and the dataset path, interleaved; then a
    profiler window of 10 online steps (busy share, the render kernel's
    device time a step), which must hold no host wait or copy.

The render kernel's launches are counted around each path (phases 4, 8
and 10) and summed in the ``{"kernels": [...]}`` JSON line, which is
followed by the ``{"ok": true, ...}`` JSON object as the last line.
Without a CUDA device, or without the repository beside it, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import shutil
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
# served answers on the card against the CPU, TF32 off: the same float32
# math summed in other orders (cuBLAS may pick another algorithm at batch
# 1 than at 128)
SERVE_TOL = 1e-4
SERVE_BATCHES = (1, 7, 128)
# profiler events of a host that waits for the device or copies to or from
# it (a .item() of a CUDA tensor, a tensor made from host data); the
# profiled window's own closing torch.cuda.synchronize() is a
# cudaDeviceSynchronize. aten::_local_scalar_dense is left out: Adam reads
# its step counts, which live on the CPU, that way, 2 a parameter a step
HOST_WAIT_EVENTS = ("cudaStreamSynchronize", "Memcpy HtoD", "Memcpy DtoH")


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


def host_waits(kernels_and_events) -> dict:
    """The events of a profiled window that make the host wait for the
    device or copy between them: {name: count}."""
    return {e.key: e.count for e in kernels_and_events
            if any(w in e.key for w in HOST_WAIT_EVENTS)}


def profile_window(fn) -> tuple[float, float, str, list, dict]:
    """Run ``fn`` once warm and once under torch.profiler. Returns (device
    kernel time s, wall time s, top-kernel table, the kernels' averages
    sorted by device time, the window's host waits and copies)."""
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
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-6
    kernels.sort(key=lambda e: -e.self_device_time_total)
    table = "\n".join(
        f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
        f"{e.key[:90]}" for e in kernels[:12])
    return busy, wall, table, kernels, host_waits(events)


class Tee(io.TextIOBase):
    """Standard output that is also kept, to check what a CLI printed."""

    def __init__(self):
        self.kept = io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()


def run_cli(args: list[str]) -> str:
    """Run the port's CLI in this process; return what it printed."""
    from cdgvae_torch.cli import main as cli_main

    tee = Tee()
    with contextlib.redirect_stdout(tee):
        cli_main.main(args)
    sys.stdout.flush()
    return tee.kept.getvalue()


def read_records(path: Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


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

    from cdgvae_torch.api import LoadedModel
    from cdgvae_torch.data.pendulum import PendulumDataset, sample_factors_real
    from cdgvae_torch.factory import build_pendulum_model
    from cdgvae_torch.ops import _build, renderer_cuda
    from cdgvae_torch.ops.renderer import render_reference
    from cdgvae_torch.train.loop import format_epoch, run_epochs
    from cdgvae_torch.train.online import (make_online_scanned_steps,
                                           pendulum_batch_fn,
                                           sample_factors_device,
                                           train_split_size)
    from cdgvae_torch.train.scanned import (Averager, epoch_batches,
                                            make_epoch_runner,
                                            make_supervised_loss_fn)
    from cdgvae_torch.train.steps import make_optimizer, make_train_step
    from cdgvae_torch.utils.checkpoint import load_checkpoint
    from cdgvae_torch.utils.simulation import ONLINE_STEP, derived_seed

    dev = torch.device("cuda")

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, numpy "
          f"{np.__version__}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    # checkpoints cross between the packages on the CPU test machine, which
    # has JAX; here the port reads and writes its own
    print("checkpoint exchange with the JAX package: not run here (no JAX "
          "on this machine; tests/test_torch_checkpoint.py on the CPU)")
    work = root / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)

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

    def check_render(name: str, out: torch.Tensor, f: torch.Tensor,
                     size: int = 64, bg: torch.Tensor | None = None) -> float:
        """Hold images ``out`` of factors ``f`` [n, 4] against
        render_reference; returns max |d|."""
        torch.cuda.synchronize()
        ref = render_reference(f, size, bg)
        check(out.shape == ref.shape, f"{name}: shape {out.shape}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out - ref).abs()
        mx, mean = diff.max().item(), diff.mean().item()
        print(f"render {name}: max|d| {mx:.3e} mean|d| {mean:.3e}")
        tol = MAX_ABS_TOL if size <= 128 else MAX_ABS_TOL_512
        check(mx <= tol and mean <= MEAN_ABS_TOL,
              f"render {name} disagrees with render_reference "
              f"(max {mx}, mean {mean})")
        return mx

    max_err = 0.0
    for name, f, bg, size in cases:
        mx = check_render(name, renderer_cuda.render_cuda(f, size, bg), f,
                          size, bg)
        if size <= 128:  # the kernels line: the cases held to MAX_ABS_TOL
            max_err = max(max_err, mx)

    # the online step's launch: 128 images into a caller's buffer, which
    # starts as NaN so that a pixel left unwritten fails
    buf = torch.full((BATCH, 64, 64, 3), math.nan, device=dev)
    got = renderer_cuda.render_cuda(f_all[:BATCH], 64, out=buf)
    check(got.data_ptr() == buf.data_ptr(), "render_cuda(out=) returned "
          "another tensor")
    max_err = max(max_err, check_render(f"B={BATCH} out=", buf,
                                        f_all[:BATCH]))

    # 4. the dataset path, with the launch counts read around it
    path_launches = {}
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
    stamps = [time.perf_counter()]

    def on_epoch(epoch, metrics):
        stamps.append(time.perf_counter())
        print(format_epoch(epoch, metrics), flush=True)

    history = run_epochs(step, dataset.x_data, dataset.y_data, seed=1,
                         epochs=EPOCHS, batch_size=BATCH, on_epoch=on_epoch)
    torch.cuda.synchronize()
    path_launches["dataset"] = renderer_cuda.launches
    print(f"dataset path launches: {{'render': {path_launches['dataset']}}}")
    check(len(dataset) == 3712, f"dataset has {len(dataset)} images")
    check(path_launches["dataset"] > 0,
          "the render kernel never launched on the dataset path")
    losses = [m["loss"] for m in history]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    steps = len(dataset) // BATCH
    step_s = (stamps[-1] - stamps[-2]) / steps  # unprofiled, last epoch
    train_imgs_s = steps * BATCH / (stamps[-1] - stamps[-2])
    print(f"train: {steps} steps/epoch, last epoch "
          f"{stamps[-1] - stamps[-2]:.4f} s = {train_imgs_s:.1f} imgs/s "
          f"(host clock, [{card}])")
    # one more such epoch after each later phase: whether what a phase
    # leaves behind changes the host's time a step
    data_epoch = make_epoch_runner(step, BATCH)

    def probe_host(after: str):
        t0 = time.perf_counter()
        data_epoch(dataset.x_data, dataset.y_data,
                   torch.Generator(device=dev).manual_seed(200))
        print(f"host time a step, one dataset epoch after {after}: "
              f"{(time.perf_counter() - t0) / steps * 1e3:.3f} ms [{card}]")

    probe_host("phase 4")

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
    probe_host("phases 5-6 (the loss on the CPU, event timing)")

    # 7. a profiled window: device busy share of the train step and its
    # kernels, and the render kernel's device time without host overhead
    generator = torch.Generator(device=dev).manual_seed(1)
    order = epoch_batches(len(dataset), BATCH, generator)[:10]
    busy, wall, table, _, waits = profile_window(
        lambda: [step(dataset.x_data[i], dataset.y_data[i],
                      generator=generator) for i in order])
    if busy > 0:
        print(f"train step, profiled {len(order)} steps: device busy "
              f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall; per step "
              f"{busy / len(order) * 1e3:.3f} ms busy of "
              f"{step_s * 1e3:.3f} ms unprofiled = "
              f"{busy / len(order) / step_s:.3f} busy share; host waits "
              f"and copies {waits} [{card}]")
        print(table)
        for n in (3712, 2048, 128):
            f = f_all[:n]
            out = torch.empty((n, 64, 64, 3), device=dev)
            busy, wall, _, _, _ = profile_window(
                lambda: [renderer_cuda.render_cuda(f, 64, out=out)
                         for _ in range(20)])
            print(f"render B={n} device time (profiler): "
                  f"{busy / 20 * 1e6:.2f} us per launch, "
                  f"{wall / 20 * 1e6:.2f} us wall per call; events "
                  f"{rows[n][0] * 1e3:.2f} us [{card}]")
    else:
        print("profiler saw no device kernels: busy share not measured")
    probe_host("phase 7 (torch.profiler)")

    # 8. the CLI at full width: train, checkpoint, resume
    cli_dir = work / "cli"
    ckpt = cli_dir / "model_CDGVAE_linear"
    renderer_cuda.launches = 0
    t0 = time.perf_counter()
    said = run_cli(["--n_samples", str(N_SAMPLES), "--epochs", "2",
                    "--assets_dir", str(cli_dir)])
    cli_s = time.perf_counter() - t0
    for name in ("state.pkl", "config.json"):
        check((ckpt / name).is_file(), f"the CLI wrote no {name}")
    check((cli_dir / "recon.png").is_file(), "the CLI wrote no recon.png")
    check(f"checkpoint saved to {ckpt}" in said, "no 'checkpoint saved' line")
    check(len(read_records(cli_dir / "metrics.jsonl")) == 2,
          "metrics.jsonl does not hold 2 records")
    said = run_cli(["--n_samples", str(N_SAMPLES), "--epochs", "3",
                    "--assets_dir", str(cli_dir), "--resume", str(ckpt)])
    path_launches["cli"] = renderer_cuda.launches
    check(f"resumed from {ckpt} at epoch 2" in said, "no 'resumed' line")
    ck = load_checkpoint(str(ckpt))
    check(ck["step"] == 3, f"the resumed checkpoint is at step {ck['step']}")
    check(int(ck["opt_state"][0].count) == 3 * steps,
          f"Adam count {int(ck['opt_state'][0].count)}, not {3 * steps}")
    records = read_records(cli_dir / "metrics.jsonl")
    check([r["step"] for r in records] == [0, 1, 2],
          f"metric log steps {[r['step'] for r in records]}")
    check(all(math.isfinite(r["loss"]) for r in records), "non-finite loss")
    print(f"cli: 2 epochs in {cli_s:.3f} s (host clock, dataset build and "
          f"checkpoint included), resumed to epoch 3; cli path launches: "
          f"{{'render': {path_launches['cli']}}} [{card}]")
    probe_host("phase 8 (the CLI)")

    # 9. serving the CLI's checkpoint on the card and on the CPU
    served = {"cuda": LoadedModel.load(str(ckpt), device=dev),
              "cpu": LoadedModel.load(str(ckpt), device="cpu")}
    x_host = dataset.x_data[:max(SERVE_BATCHES)].cpu().numpy()
    eps_host = rng.standard_normal((max(SERVE_BATCHES), 4)).astype(np.float32)
    requests = {"encode": lambda m, x, e: m.encode(x),
                "reconstruct": lambda m, x, e: m.reconstruct(x),
                "generate": lambda m, x, e: m.generate(e)}
    for d in range(4):
        requests[f"counterfactual do{d}"] = (
            lambda m, x, e, d=d: m.counterfactual(x, d, 0.5))
    serve_err = 0.0
    for b in SERVE_BATCHES:
        x, e = x_host[:b], eps_host[:b]
        for name, req in requests.items():
            got, want = req(served["cuda"], x, e), req(served["cpu"], x, e)
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"serve {name} b={b}: shape {got.shape} or non-finite")
            err = float(np.abs(got - want).max())
            serve_err = max(serve_err, err)
            check(err <= SERVE_TOL, f"serve {name} b={b}: cuda against cpu "
                  f"max |d| {err} > {SERVE_TOL}")
            ms = time_ms(lambda: req(served["cuda"], x, e), reps=10,
                         rounds=3)
            print(f"serve {name} b={b}: {ms:.3f} ms per request (events, "
                  f"numpy in and out), max |d| cuda-cpu {err:.3e} [{card}]")
        check(served["cuda"].sample(b).shape == (b, 64, 64, 3),
              f"sample({b}) shape")
    print(f"serving: max |d| cuda against cpu {serve_err:.3e} "
          f"(limit {SERVE_TOL})")
    probe_host("phase 9 (serving, on the CPU too)")

    # 10. the online trainer through the CLI, then a profiled window
    online_dir = work / "online"
    renderer_cuda.launches = 0
    t0 = time.perf_counter()
    run_cli(["--online", "--n_samples", str(N_SAMPLES), "--epochs", "2",
             "--assets_dir", str(online_dir)])
    online_cli_s = time.perf_counter() - t0
    path_launches["online"] = renderer_cuda.launches
    online_steps = 2 * (train_split_size(N_SAMPLES) // BATCH)
    losses = [r["loss"] for r in read_records(online_dir / "metrics.jsonl")]
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses),
          f"online losses {losses}")
    check(losses[1] < losses[0], f"online loss did not fall: {losses}")
    check(path_launches["online"] >= online_steps,
          f"{path_launches['online']} render launches for {online_steps} "
          "online steps")
    print(f"online: {online_steps} steps in {online_cli_s:.3f} s through "
          f"the CLI (host clock); online path launches: "
          f"{{'render': {path_launches['online']}}} [{card}]")
    # the online batch, drawn and rendered into the batch function's buffer,
    # against render_reference of the same factors drawn again
    sample = pendulum_batch_fn(BATCH, 64, device=dev)
    x_online, _ = sample(torch.Generator(device=dev).manual_seed(5))
    f_online = sample_factors_device(
        torch.Generator(device=dev).manual_seed(5), BATCH)
    max_err = max(max_err, check_render(
        f"online batch B={BATCH} (pendulum_batch_fn)", x_online,
        f_online[:, :4].contiguous()))

    # host time a step: an epoch (29 steps) of each path timed the same
    # way, on the host clock ending in the epoch's one host sync, the two
    # paths interleaved, 3 rounds after a warm one
    model, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
    optimizer = make_optimizer(model, LR)
    online_run = {n: make_online_scanned_steps(
        model, optimizer, BETA, LAM, BATCH, n, 64, sample_batch=sample,
        seed=1, device=dev) for n in (steps, 10)}
    draw = torch.Generator(device=dev).manual_seed(0)

    def online_epoch(k):
        avg = Averager()
        avg.add(online_run[steps](k * steps))
        return avg.result()

    def draws(k):
        for _ in range(steps):
            sample(draw)
        torch.cuda.synchronize()

    def reseeds(k):  # what an online step does besides the draw and step
        for i in range(k * steps, (k + 1) * steps):
            draw.manual_seed(derived_seed(1, ONLINE_STEP, i))

    paths = {"dataset": lambda k: data_epoch(
                 dataset.x_data, dataset.y_data,
                 torch.Generator(device=dev).manual_seed(100 + k)),
             "online": online_epoch, "draw and render": draws,
             "generator reseed": reseeds}
    per_step = {name: [] for name in paths}
    for k in range(4):
        for name, fn in paths.items():
            t0 = time.perf_counter()
            fn(k)
            if k:  # round 0 warms
                per_step[name].append((time.perf_counter() - t0) / steps)
    med = {name: statistics.median(v) for name, v in per_step.items()}
    for name, v in per_step.items():
        print(f"host time a step, {name}, epochs of {steps} steps: "
              f"{', '.join(f'{s * 1e3:.3f}' for s in v)} ms, median "
              f"{med[name] * 1e3:.3f} ms [{card}]")

    busy, wall, table, kernels, waits = profile_window(
        lambda: online_run[10](0))
    if busy > 0:
        render_us = sum(k.self_device_time_total for k in kernels
                        if "render_kernel" in k.key) / 10
        print(f"online step, profiled 10 steps: device busy "
              f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall; per step "
              f"{busy / 10 * 1e3:.3f} ms busy of {med['online'] * 1e3:.3f} "
              f"ms unprofiled = {busy / 10 / med['online']:.3f} busy share; "
              f"render kernel {render_us:.2f} us device time a step; host "
              f"waits and copies {waits} [{card}]")
        print(table)
        check(not waits, f"the online step waits for the device or copies "
              f"to or from it: {waits}")
    else:
        print("profiler saw no device kernels: online busy share and host "
              "waits not measured")
    # what the host's time a step drifts with: the CPU thread pool (the
    # CPU work of phases 5 and 9 starts it) and the garbage collector
    probe_host("phase 10")
    torch.set_num_threads(1)
    probe_host("torch.set_num_threads(1)")
    gc.collect()
    gc.freeze()
    probe_host("gc.collect() and gc.freeze()")
    shutil.rmtree(work, ignore_errors=True)

    launches = sum(path_launches.values())
    print(f"render launches by path: {path_launches}, total {launches}")
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "render", "route": "cuda",
        "source": "cdgvae_torch/csrc/render.cu",
        "replaces": "cdgvae_tpu/ops/renderer_pallas.py:146",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
