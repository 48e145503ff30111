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
    device time a step), which must hold no host wait or copy;
11. semi-supervised training through ``cdgvae_torch.cli.main_semi``
    (labeled 10%, labeled batch 32): 2 epochs on the fixed datasets, then
    ``--resume`` to 3, then ``--online`` for 2 epoch-equivalents; losses
    finite and falling, 2 render launches a fixed run and one a step
    online; the semi step's host time over whole epochs, interleaved with
    the dataset step; profiler windows of 10 semi steps, on the datasets
    and online, which must hold no host wait or copy;
12. InfoMax through ``cli.main --model InfoMax``: 2 epochs, ``--resume``
    to 3 (the checkpoint's discriminator extras and both Adam counts),
    ``--eager`` and ``--online``; MutualInfo finite in every metric line;
    the full-width InfoMax loss on the card against the CPU (same weights,
    batch, noise and permutation); host time a step and busy share;
13. eval: ``cli.main_classifier`` for 2 epochs, ``cli.metric`` on phase 8's
    and phase 11's checkpoints, whose structural-zero CDM entries must read
    exactly 0.0; ``cdm_matrices`` on 512 images on the card against the
    CPU; ``cli.inference`` writes its seven figures; the CLIs' wall times;
14. DR and downstream: the DR train split rendered in one launch with the
    background bit and held against ``render_reference``, the kernel with
    the bit timed at 3,712 and 128 images beside its bound and the time
    without the bit; ``cli.dr_main`` (node 5, lambda 20) for 2 epochs,
    ``--resume`` to 3, ``--eager``, ``--online`` and ``--model InfoMax``,
    and ``cli.dr_main_semi`` fixed and ``--online``, losses finite and
    falling; the online DR batch against ``render_reference``; the
    full-width DR loss and the served DR checkpoint on the card against
    the CPU; host time a step of the DR dataset, online and semi steps
    interleaved with the dataset step, and their profiled windows (no
    host wait or copy); ``cli.dr_robustness``, ``cli.sample_efficiency``
    (phase 8's checkpoint), ``cli.toy_dr`` and ``cli.inference`` on the DR
    checkpoint, with their walls and what a run at the defaults takes;
15. PNG trees: the kernel at the export's 96 px against
    ``render_reference`` and its bound; ``cli.generate_data`` at its
    defaults and a cut DR export, the files against ``render_reference``;
    ``load_png_dataset`` of the export, the decoder on its files and on
    the same pixels filtered as Pillow filters them (pixels equal), the
    load of both trees; ``cli.main --data_dir``, ``cli.metric`` and
    ``cli.inference`` on that checkpoint, ``cli.dr_main --data_dir``;
16. the tabular family at its full synthetic sizes through
    ``cli.tabular_main``, ``cli.tabular_inference`` and
    ``cli.dag_discovery``, the loss and served answers on the card against
    the CPU, host ms and device busy a step;
17. the CDG-TVAE at its full synthetic sizes: the DataTransformer's fit
    and transform (host ms, output widths); ``cli.tabular_main_tvae`` at
    its defaults but 2 epochs on every dataset, and on loan ``--resume``,
    ``--eager`` and ``--profile`` (2 epochs; the trace ranks CUDA kernels
    and closes after its window of optimizer steps: the eager first step,
    its capture and the replays); the TVAE
    loss and data-space serving on the card against the CPU; host ms and
    device busy a step, with no host wait or copy; ``cli.
    tabular_inference_tvae`` on each checkpoint. The TVAE path renders
    nothing: its launch count must be 0;
18. the CelebA family at ``cli.celeba_main``'s defaults (128 px,
    conv_dim 32, ResNet-18, batch 16) on its 64 synthetic faces:
    ``cli.celeba_main`` for 2 epochs with a checkpoint each, ``--resume``
    to 3 and an uninterrupted 3-epoch run, whose params must equal the
    resumed run's bit for bit (``celeba_main`` runs cuDNN's deterministic
    algorithms), the same three with ``--bf16``, then ``--eager``,
    ``--train_trunk``,
    ``--align_warmup 1``, ``--stacked_decoder true``, ``--async_ckpt
    true`` and ``--profile`` (1-2 epochs each, the checkpoint's step and
    Adam count checked; on the card each epoch replays a CUDA graph a
    step, so the trace holds the eager first step, its capture and the
    replays); the full-width loss on the card against the CPU
    (TF32 off for matmuls and cuDNN); ``LoadedModel`` encode, reconstruct
    and counterfactual at batch 1 and 16 against the CPU; host ms a step,
    f32 and bf16 interleaved, the device's busy share over 10 profiled
    steps (no host wait or copy), kernels a step and the host's time by
    op over the same 10 steps, achieved TFLOP/s from the FLOP count
    (held to torch's ``FlopCounterMode`` within 1%) against the float32
    and bfloat16 peaks, and the peak memory. It renders nothing: 0
    launches;
19. data parallelism in a world-1 NCCL group (the one card): the flagship
    through the sharded epoch runner for 2 epochs against the one-device
    runner (losses and params bit for bit), host ms a step of the two
    interleaved and the time of the gradient mean (NCCL's all-reduce of
    the flat gradient buffer and its division) on CUDA events, its device
    time (events around calls queued behind a sleeping kernel, and the
    profiler's kernels); the sharded online trainer
    for 2 epoch-equivalents against the one-device one (bit for bit; its
    render launches counted as ``dp online``); one CelebA epoch at
    ``cli.celeba_main``'s defaults through the sharded trainer with
    ``sn_refresh`` against the one-device one (cuDNN deterministic; bit
    for bit) and its gradient mean's times; ``cli.main --dp 1``,
    ``--dp 0`` and ``--dp 1 --online`` on one device, ``--dp 2`` refused
    by the device count; ``LoadedModel(mesh=make_mesh(1, "cuda"))``
    against plain serving (max |d| 0); ``dryrun_multichip`` over every
    card;
20. the packed parameter layout (``ops/packing.py``) at
    ``cli.celeba_main``'s defaults, f32 and bf16: 3 steps packed against
    unpacked from one init and one draw stream (cuDNN deterministic;
    params, Adam moments and metrics bit for bit), then host ms a step of
    the four paths interleaved and 2 profiled steps each (kernels a step,
    device busy, ``cudaLaunchKernel`` ms); CelebAMask-HQ preprocessing of
    ``tests/torch_fixtures/celeba_hq/corpus`` through ``python -m
    cdgvae_torch.cli.celeba_preprocess`` (once in its own process, then
    in this one) at 128 and 64 px, both structures and both splits, every
    ``.npy`` file's hash against ``expected.json`` (the JAX package's
    output), and files a second at 1024 px over copies of the 1024 px
    face, enough for 15 s of decoding (host decode and device ms a
    file). Neither path renders: 0
    launches each;
21. the library options that no CLI sets, at full width: 10 bf16 steps
    (``compute_dtype``) against 10 float32 steps from one init (losses
    finite and falling, params and Adam state float32); one bf16 step on
    the card against the same step on the CPU (the metrics within one
    bf16 ulp, the gradients within 2e-2 of each tensor's largest entry);
    host ms and device busy a step, bf16 against f32, on the dataset and
    the online paths; uint8
    storage of phase 4's dataset (``quantize_images``): one epoch on it
    against one on its dequantised float32 copy (params bit for bit), its
    bytes on the device and host ms a step; then the CDM study of
    ``tools/cdm_seeds.py`` cut to one seed, 2 epochs and a 1-epoch
    classifier on the cut DGP, whose protected cells must be exactly 0.0
    (one render launch);
22. the studies of ``tools/``, each cut to seed 1, 2 epochs and 512
    samples, each run twice: graphed (the tools' default on the card) and
    ``eager=True``, both with capturable Adams, whose results (the trained
    parameters' digest, the loss curve, the CDM or the record) must be
    equal bit for bit; their train seconds are printed.
    ``cdm_seeds.run_seed`` from the JAX package's initial parameters
    (``tools/jax_init.py``), semi and InfoMax (the classifier graphed
    too), ``se_seeds.run_seed``, ``online_seeds.run_seed`` and its semi
    protocol (a render launch a step: the eager first step's and one a
    replay), ``dr_sweep.run_config`` fixed and online at lambda 40 with 1
    robustness repeat, and ``tabular_seeds``' CDG-VAE (2 epochs) and TVAE
    (1 epoch) on loan; the results must be finite and the protected CDM
    cells exactly 0.0, and each run's render launches are counted. Then
    three graphed cut seeds of ``cdm_seeds`` in one process, whose peak
    device memory after the third may exceed the peak after the first by
    at most 64 MiB; ``tabular_seeds``' ``main`` on loan (both protocols),
    whose summaries must say ``"dispatch": "graphed"`` (0 launches); the
    CelebA study through ``tools/celeba_study.py``'s ``main`` cut to 32
    faces at 32 px, conv_dim 8, 2 epochs: its corpus, training through
    ``celeba_main`` in a subprocess, the scores and the do-grid, whose
    do-leakage outside the masks must be exactly 0.0 (0 launches); and
    the same seed as two arms of ``tools/celeba_arms.py``, trained one
    after the other in one worker process: each arm's scores must equal
    the study's (but the wall time), and the device memory allocated
    after each arm (cuBLAS's cached workspaces released) may not exceed
    what it was before (0 launches);
23. the CUDA-graph epoch runner (``make_epoch_runner(graph_noise=)``)
    against the eager runner, from one init and one seed, both with a
    capturable Adam: the full-width flagship for 3 epochs on phase 4's
    dataset, and CelebA at ``cli.celeba_main``'s defaults (packed, f32
    and bf16) for 3 epochs on its 64 synthetic faces, the graphed run
    resumed from a checkpoint after epoch 2. Parameters, buffers (the
    spectral-norm vectors), Adam moments and step counts and the epoch
    metrics must be equal bit for bit; then host ms a step of the two
    runners interleaved, device busy a step from the profiler's kernels
    over an epoch of each, and a replay's device time on CUDA events.
    The graphed epochs render nothing: 0 launches;
24. the graphed runners of the other trainers against their eager
    runners, from one init and one seed, each with capturable Adams: the
    semi-supervised runner (``main_semi``'s defaults, batch 128, labeled
    batch 32, on phase 4's dataset), the InfoMax pair (the
    ``permutation`` marginal), the DR CDG-VAE and DR semi on the DR train
    split, the tabular CDG-VAE and InfoMax and the TVAE with its sigma
    clamp on loan at the full synthetic size, each for 3 epochs; and the
    online trainer (pendulum, DR, semi and InfoMax at full width, 2 calls
    of 29 steps), whose graph holds the render kernel: its launches must
    equal the steps, eager and graphed (a capture counts none, a replay
    the launches its graph holds). Parameters, buffers, Adam moments and
    step counts and the metrics must be equal bit for bit; then the
    InfoMax graphed run resumed from a checkpoint after epoch 2 (with the
    discriminator's state, through ``cli.common.apply_resume``) against
    the uninterrupted eager run; then, for each path, host ms a step of
    the two runners interleaved (median of 3 rounds), device busy and
    kernels a step from the profiler over a call of each, and a replay's
    device time on CUDA events;
25. the capturable Adam of the graphed trainers
    (``train/steps.py::CapturableAdam``) against a float64 copy of
    optax's update, fed the same float32 gradients
    (``tools/adam_check.py``): the 16 px CDG-VAE and the packed CelebA
    buffers, the Adam eager and inside a captured CUDA graph, beside the
    plain Adam; after 1 step within 1e-7, after 200 steps (the graph: 200
    replays) within 1e-6 and within 3 x the plain Adam's distance.

The CLIs of phases 8-17 replay graphs on the card by default
(``--eager`` and ``--dp`` stay eager): phase 17's ``--profile`` trace
holds the eager first step, its capture and the replays of its window.
The render kernel's launches are counted around each path (phases 4, 8,
10-15, 19, 21, 22 and 24, and 17's, 18's, 20's, 23's and 25's 0) and
summed in the ``{"kernels": [...]}`` JSON line, which is followed by the
``{"ok": true, ...}`` JSON object as the last line.
Without a CUDA device, or without the repository beside it, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import math
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# and the dense bfloat16 tensor-core peak (the same data sheet, without
# sparsity)
PEAK_BF16_OPS_PER_S = 989e12
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
STUDY_N = 512  # phase 22's cut of the studies' DGP
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
BATCH_L, LR_D, GAMMA = 32, 1e-4, 1.0  # main_semi's and InfoMax's defaults
DR_LAM = 20.0  # dr_main's default; dr_main_semi keeps LAM
# the downstream evals at a cut that fits the time limit (their defaults
# are 10 repeats and 500 robustness epochs; phase 14 prints what those
# would take)
EVAL_REPEATS, ROBUSTNESS_EPOCHS = 3, 100
# phase 15: cli.generate_data's defaults (10,000 samples at 96 px, chunks
# of 2,048), the DR export cut to 2,000
EXPORT_N, EXPORT_PX, EXPORT_CHUNK, EXPORT_DR_N = 10000, 96, 2048, 2000
# phase 16: tabular_main's defaults; steps an epoch at the full synthetic
# sizes (train rows 4,000, 40,000 and 10,000)
TAB_BATCH, TAB_BETA, TAB_LAM, TAB_LR = 256, 0.01, 10.0, 0.01
TAB_STEPS = {"loan": 15, "adult": 156, "covtype": 39}
# phase 17: tabular_main_tvae's defaults; the transformer fits 4,000,
# 4,000 and 10,000 rows, so 15, 15 and 39 steps an epoch at batch 256
TVAE_LAM, TVAE_LR, TVAE_WD, TVAE_SIGMA = 5.0, 1e-3, 1e-5, (0.01, 0.1)
TVAE_STEPS = {"loan": 15, "adult": 15, "covtype": 39}
# phase 18: cli.celeba_main's defaults (128 px, conv_dim 32, ResNet-18,
# node and latent_dim 6, batch 16, Adam 1e-3, beta 0.1, lambda 5) on its
# 64 synthetic faces, 4 steps an epoch
CELEBA_BATCH, CELEBA_BETA, CELEBA_LAM, CELEBA_LR = 16, 0.1, 5.0, 1e-3
CELEBA_STEPS = 4
# phase 21: one bf16 step on the card against the same step on the CPU.
# cuBLAS and the CPU's bf16 GEMMs accumulate in other orders, so a bf16
# activation can round to its neighbour: the metrics within one bf16 unit
# in the last place, relative (2^-7; the JAX-against-port bound of
# tests/test_torch_bf16.py, 1e-4, read 1.638e-3 here at full width); a
# gradient's max |d| within 2e-2 of its tensor's largest entry, as there
BF16_METRIC_RTOL, BF16_GRAD_FRACTION = 2.0 ** -7, 2e-2
# TVAE serving in data space, card against CPU: the encode as SERVE_TOL;
# a float column within this times 4 sigma of its widest valid component
# (the inverse scales the decoder's float32 output by it), integer and
# discrete columns equal
TVAE_COLUMN_TOL = 1e-4
# the downstream fit on the card (CUDA-graph epochs) against the CPU's
# eager steps: 2 epochs of float32 products summed in other orders
FIT_TOL = 1e-5
# CDM on the card against the CPU: scores are sigmoids of float32 sums over
# 12,288 pixels in other orders, averaged over the images
CDM_TOL = 1e-4
# (source, checked) CDM entries that the masked GAM decoder holds at exactly
# 0: do(length) and do(position) cannot move light or angle, do(light)
# cannot move angle, do(angle) cannot move light
STRUCTURAL_ZEROS = ((2, 0), (2, 1), (3, 0), (3, 1), (0, 1), (1, 0))
INFERENCE_PNGS = ("latent_maxmin_orig.png", "latent_maxmin.png",
                  "posterior_variance.png", "crossentropy.png",
                  "original_and_recon.png", "gam.png", "do.png")
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


def device_ms(fn, reps: int = 20) -> float:
    """The device time of ``fn`` a call, from CUDA events around ``reps``
    calls that the host queues while a sleeping kernel holds the stream,
    so that no host gap falls between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_waits(kernels_and_events) -> dict:
    """The events of a profiled window that make the host wait for the
    device or copy between them: {name: count}."""
    return {e.key: e.count for e in kernels_and_events
            if any(w in e.key for w in HOST_WAIT_EVENTS)}


def profile_window(fn, warm: bool = True
                   ) -> tuple[float, float, str, list, dict]:
    """Run ``fn`` once warm (unless ``warm`` is false: it has run already)
    and once under torch.profiler. Returns (device kernel time s, wall
    time s, top-kernel table, the kernels' averages sorted by device time,
    the window's host waits and copies)."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
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


def run_cli(args: list[str], cli: str = "main") -> tuple[str, object, float]:
    """Run the port's CLI ``cdgvae_torch.cli.<cli>`` in this process.
    Returns what it printed, what its ``main`` returned, and its wall time
    in seconds (host clock, ending in a device sync)."""
    import importlib

    module = importlib.import_module(f"cdgvae_torch.cli.{cli}")
    tee = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = module.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sys.stdout.flush()
    return tee.kept.getvalue(), result, wall


def interleaved_ms(paths: dict, steps: int, card: str,
                   warm: bool = True) -> dict:
    """Host time a step of each path, ``paths[name](k)`` running epoch k
    of ``steps`` steps and ending in a host sync: the paths in turn, 3
    rounds after a warm one (none when ``warm`` is false: the paths have
    run already). Prints each path's times; returns the medians in
    seconds a step."""
    per_step = {name: [] for name in paths}
    for k in range(0 if warm else 1, 4):
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
    return med


def read_csv_matrix(path: Path) -> list[list[str]]:
    with open(path) as f:
        return [line.rstrip("\n").split(",") for line in f]


def read_records(path: Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def read_text_lines(path: Path) -> list[str]:
    with open(path) as f:
        return f.read().splitlines()


def render_bound_ms(n: int, size: int, background: bool) -> tuple[float, str]:
    """Least time for the render: each input read once, the output written
    once, against the float32 operations it must do."""
    nbytes = n * 4 * 4 + (n * 4 if background else 0) + n * size * size * 3 * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n * size * size * RENDER_OPS_PER_PIXEL / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# PNG filter types in the order Pillow's encoder tries them; it keeps the
# first with the least sum of |filtered byte| read as signed
PILLOW_FILTERS = (0, 2, 1, 4)  # None, Up, Sub, Paeth (no Average)


def pillow_scanlines(pixels: np.ndarray) -> np.ndarray:
    """uint8 [n, h, w, c] -> PNG scanlines [n, h, 1 + w*c] uint8, each row
    filtered as Pillow's encoder filters it (``PILLOW_FILTERS``), its filter
    byte first: the files of a tree saved with Pillow, as users of the
    reference hold them."""
    n, h, w, c = pixels.shape
    x = pixels.reshape(n, h, w * c).astype(np.int16)
    up = np.zeros_like(x)
    up[:, 1:] = x[:, :-1]
    left = np.zeros_like(x)
    left[:, :, c:] = x[:, :, :-c]
    up_left = np.zeros_like(x)
    up_left[:, :, c:] = up[:, :, :-c]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    rows = np.stack([x, x - up, x - left, x - paeth]) & 0xFF
    best = np.minimum(rows, 256 - rows).sum(axis=-1).argmin(axis=0)
    kinds = np.array(PILLOW_FILTERS, np.uint8)[best]
    chosen = np.take_along_axis(rows, best[None, ..., None], axis=0)[0]
    return np.concatenate([kinds[..., None], chosen.astype(np.uint8)],
                          axis=-1)


def write_scanlines(path: Path, scanlines: np.ndarray) -> None:
    """An 8-bit RGB PNG of filtered scanlines [h, 1 + w*3] uint8."""
    h, stride = scanlines.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", (stride - 1) // 3, h, 8, 2,
                                     0, 0, 0))
        + chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6))
        + chunk(b"IEND", b""))


def dr_and_downstream(*, work: Path, card: str, dev, rng, steps: int,
                      online_steps: int, path_launches: dict,
                      pendulum_ckpt: Path, pendulum_rows: dict,
                      dataset_epoch, check_render, finite_falling,
                      profiled_steps) -> float:
    """Phase 14: the render kernel on DR data (the background bit set on
    about half the images), the DR trainers through ``cli.dr_main`` and
    ``cli.dr_main_semi``, the full-width DR model and its serving on the
    card against the CPU, the DR steps' host and device time, and the
    downstream evals. Adds the DR paths' render launches to
    ``path_launches``; returns the largest max |d| of its render checks."""
    from cdgvae_torch.api import LoadedModel
    from cdgvae_torch.data.pendulum_dr import PendulumDRDataset
    from cdgvae_torch.eval.downstream import train_downstream
    from cdgvae_torch.factory import build_pendulum_model
    from cdgvae_torch.models.classifier import DownstreamClassifier
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.ops.renderer import render_reference
    from cdgvae_torch.train.online import (dr_batch_fn, dr_label_norm_stats,
                                           make_online_scanned_steps,
                                           sample_factors_dr_device,
                                           train_split_size)
    from cdgvae_torch.train.scanned import (Averager, epoch_batches,
                                            labeled_batches,
                                            make_epoch_runner,
                                            make_scanned_epochs_semi,
                                            make_supervised_loss_fn)
    from cdgvae_torch.train.steps import (make_optimizer, make_semi_step,
                                          make_train_step)
    from cdgvae_torch.utils.checkpoint import load_checkpoint

    # the DR train split: one launch with the background column
    renderer_cuda.launches = 0
    t0 = time.perf_counter()
    dr_ds = PendulumDRDataset(n=N_SAMPLES, device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    check(renderer_cuda.launches == 1 and len(dr_ds) == 3712,
          f"DR dataset: {renderer_cuda.launches} launches, {len(dr_ds)} "
          "images")
    f_dr = torch.as_tensor(dr_ds.factors[:, :4], dtype=torch.float32,
                           device=dev)
    bg_dr = torch.as_tensor(dr_ds.factors[:, 4], dtype=torch.float32,
                            device=dev)
    print(f"DR dataset build ({len(dr_ds)} train images, "
          f"{dr_ds.factors[:, 4].mean():.3f} of them with the background "
          f"bit): {build_ms:.3f} ms (host clock) [{card}]")
    max_err = check_render("DR dataset B=3712 bg", dr_ds.x_data, f_dr, 64,
                           bg_dr)
    for n in (3712, 128):
        f, bg = f_dr[:n], bg_dr[:n]
        max_err = max(max_err, check_render(
            f"DR B={n} bg", renderer_cuda.render_cuda(f, 64, bg), f, 64, bg))
        k_ms = time_ms(lambda: renderer_cuda.render_cuda(f, 64, bg))
        k_plain_bits = time_ms(lambda: renderer_cuda.render_cuda(f, 64))
        p_ms = time_ms(lambda: render_reference(f, 64, bg), reps=5)
        b_ms, b_by = render_bound_ms(n, 64, background=True)
        out = torch.empty((n, 64, 64, 3), device=dev)
        busy, _, _, _, _ = profile_window(
            lambda: [renderer_cuda.render_cuda(f, 64, bg, out=out)
                     for _ in range(20)])
        device_us = f"{busy / 20 * 1e6:.2f} us" if busy > 0 else \
            "not measured"
        print(f"render DR B={n} with the background bit: kernel "
              f"{k_ms * 1e3:.2f} us (device {device_us}), plain "
              f"{p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}); "
              f"the same factors without the bit {k_plain_bits * 1e3:.2f} "
              f"us; phase 6 (pendulum factors, no bit) "
              f"{pendulum_rows[n][0] * 1e3:.2f} us [{card}]")

    # cli.dr_main: 2 epochs, --resume to 3, --eager 1 epoch, --online,
    # --model InfoMax
    dr_dir = work / "dr"
    dr_ckpt = dr_dir / "model_DR_CDGVAE_linear"
    args = ["--n_samples", str(N_SAMPLES)]
    renderer_cuda.launches = 0
    _, _, dr_s = run_cli(args + ["--epochs", "2", "--assets_dir",
                                 str(dr_dir)], "dr_main")
    said, _, _ = run_cli(args + ["--epochs", "3", "--assets_dir",
                                 str(dr_dir), "--resume", str(dr_ckpt)],
                         "dr_main")
    check(f"resumed from {dr_ckpt} at epoch 2" in said, "DR: no 'resumed' "
          "line")
    ck = load_checkpoint(str(dr_ckpt))
    cfg = ck["config"]
    check(ck["step"] == 3 and int(ck["opt_state"][0].count) == 3 * steps,
          f"DR checkpoint at step {ck['step']}, Adam count "
          f"{int(ck['opt_state'][0].count)}")
    check(cfg["spurious"] is True and cfg["node"] == 5
          and cfg["lambda"] == 20, f"DR checkpoint config {cfg}")
    losses = finite_falling("DR", read_records(dr_dir / "metrics.jsonl"))
    eager_dir = work / "dr_eager"
    _, _, eager_s = run_cli(args + ["--eager", "--epochs", "1",
                                    "--assets_dir", str(eager_dir)],
                            "dr_main")
    eager = [r["loss"] for r in read_records(eager_dir / "metrics.jsonl")]
    check(len(eager) == 1 and math.isfinite(eager[0]),
          f"DR --eager losses {eager}")
    path_launches["dr"] = renderer_cuda.launches
    check(path_launches["dr"] == 3, f"DR: {path_launches['dr']} render "
          "launches, not 3 (2 epochs, the resume, --eager)")
    print(f"DR cli: 2 epochs in {dr_s:.3f} s, resumed to 3, --eager 1 epoch "
          f"in {eager_s:.3f} s (host clock, dataset builds included); "
          f"losses {losses}, eager {eager}; launches {{'render': "
          f"{path_launches['dr']}}} [{card}]")

    online_dir = work / "dr_online"
    renderer_cuda.launches = 0
    _, _, online_s = run_cli(args + ["--online", "--epochs", "2",
                                     "--assets_dir", str(online_dir)],
                             "dr_main")
    path_launches["dr online"] = renderer_cuda.launches
    check(path_launches["dr online"] >= online_steps,
          f"DR online: {path_launches['dr online']} render launches for "
          f"{online_steps} steps")
    losses = finite_falling("DR online",
                            read_records(online_dir / "metrics.jsonl"))
    print(f"DR online cli: {online_steps} steps in {online_s:.3f} s (host "
          f"clock), losses {losses}; launches {{'render': "
          f"{path_launches['dr online']}}} [{card}]")

    im_dir = work / "dr_infomax"
    renderer_cuda.launches = 0
    _, _, im_s = run_cli(args + ["--model", "InfoMax", "--epochs", "2",
                                 "--assets_dir", str(im_dir)], "dr_main")
    path_launches["dr infomax"] = renderer_cuda.launches
    check(path_launches["dr infomax"] == 1, f"DR InfoMax: "
          f"{path_launches['dr infomax']} render launches, not 1")
    extras = load_checkpoint(str(im_dir / "model_DR_InfoMax_linear"))[
        "extras"] or {}
    check({"d_params", "opt_state_d"} <= set(extras),
          f"DR InfoMax checkpoint extras {sorted(extras)}")
    records = read_records(im_dir / "metrics.jsonl")
    check(all(math.isfinite(r["MutualInfo"]) for r in records),
          "DR InfoMax: non-finite MutualInfo")
    losses = finite_falling("DR InfoMax", records)
    print(f"DR InfoMax cli: 2 epochs in {im_s:.3f} s (host clock), losses "
          f"{losses}; launches {{'render': {path_launches['dr infomax']}}} "
          f"[{card}]")

    # the online DR batch, drawn and rendered into the batch function's
    # buffer, against render_reference of the same draw, background included
    sample = dr_batch_fn(BATCH, 64, device=dev)
    x_online, y_online = sample(torch.Generator(device=dev).manual_seed(5))
    f_online = sample_factors_dr_device(
        torch.Generator(device=dev).manual_seed(5), BATCH,
        dr_label_norm_stats(device=dev)[0])
    check(y_online.shape == (BATCH, 6), f"DR online labels {y_online.shape}")
    max_err = max(max_err, check_render(
        f"DR online batch B={BATCH} (dr_batch_fn)", x_online,
        f_online[:, :4].contiguous(), 64, f_online[:, 4].contiguous()))

    # cli.dr_main_semi: 2 epochs, then --online
    semi_args = args + ["--labeled_ratio", "0.1", "--batch_sizeL",
                        str(BATCH_L)]
    semi_dir, semi_online_dir = work / "dr_semi", work / "dr_semi_online"
    renderer_cuda.launches = 0
    _, _, semi_s = run_cli(semi_args + ["--epochs", "2", "--assets_dir",
                                        str(semi_dir)], "dr_main_semi")
    path_launches["dr semi"] = renderer_cuda.launches
    check(path_launches["dr semi"] == 2, f"DR semi: "
          f"{path_launches['dr semi']} render launches, not 2")
    semi_cfg = load_checkpoint(str(
        semi_dir / "model_DR_CDGVAEsemi_nonlinear"))["config"]
    check(semi_cfg["lambda"] == 5 and semi_cfg["node"] == 5,
          f"DR semi config lambda {semi_cfg['lambda']} node "
          f"{semi_cfg['node']}")
    losses = finite_falling("DR semi", read_records(semi_dir /
                                                    "metrics.jsonl"))
    renderer_cuda.launches = 0
    _, _, semi_online_s = run_cli(semi_args + [
        "--online", "--epochs", "2", "--assets_dir", str(semi_online_dir)],
        "dr_main_semi")
    path_launches["dr semi online"] = renderer_cuda.launches
    check(path_launches["dr semi online"] >= online_steps + 1,
          f"DR semi online: {path_launches['dr semi online']} render "
          f"launches for {online_steps} steps")
    online_losses = finite_falling(
        "DR semi online", read_records(semi_online_dir / "metrics.jsonl"))
    print(f"DR semi cli: 2 epochs in {semi_s:.3f} s, losses {losses}; "
          f"--online {online_steps} steps in {semi_online_s:.3f} s, losses "
          f"{online_losses} (host clock); launches {{'render': "
          f"{path_launches['dr semi']}}} and {{'render': "
          f"{path_launches['dr semi online']}}} [{card}]")

    # the full-width DR model on the card against the CPU (same weights,
    # batch and noise), then serving the DR checkpoint on both
    dr_cfg = dict(FLAGSHIP, node=5)
    noise = torch.as_tensor(rng.standard_normal((BATCH, 5)),
                            dtype=torch.float32)
    result = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        m, _ = build_pendulum_model(dr_cfg, spurious=True, device=d, seed=0)
        loss, _ = make_supervised_loss_fn(m, BETA, DR_LAM)(
            dr_ds.x_data[:BATCH].to(d), dr_ds.y_data[:BATCH].to(d),
            noise=noise.to(d))
        result[name] = loss.item()
    rel = abs(result["cuda"] - result["cpu"]) / abs(result["cpu"])
    print(f"full-width DR loss cuda {result['cuda']:.6f} cpu "
          f"{result['cpu']:.6f} rel {rel:.2e}")
    check(rel <= 1e-5, "full-width DR loss on the card disagrees with the "
          "CPU")
    served = {"cuda": LoadedModel.load(str(dr_ckpt), device=dev),
              "cpu": LoadedModel.load(str(dr_ckpt), device="cpu")}
    check(served["cuda"].model.kmax == 3, "the served DR model is not the "
          "spurious wiring")
    x_host = dr_ds.x_data[:BATCH].cpu().numpy()
    requests = {"encode": lambda m, x: m.encode(x),
                "reconstruct": lambda m, x: m.reconstruct(x)}
    for d in range(5):
        requests[f"counterfactual do{d}"] = (
            lambda m, x, d=d: m.counterfactual(x, d, 0.5))
    serve_err = 0.0
    for b in (7, BATCH):
        for name, req in requests.items():
            got, want = req(served["cuda"], x_host[:b]), req(served["cpu"],
                                                              x_host[:b])
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"DR serve {name} b={b}: shape {got.shape} or non-finite")
            err = float(np.abs(got - want).max())
            serve_err = max(serve_err, err)
            check(err <= SERVE_TOL, f"DR serve {name} b={b}: cuda against "
                  f"cpu max |d| {err} > {SERVE_TOL}")
    print(f"DR serving (encode, reconstruct, counterfactual on 5 nodes, "
          f"batch 7 and {BATCH}): max |d| cuda against cpu {serve_err:.3e} "
          f"(limit {SERVE_TOL})")

    # host time a step of the DR paths, interleaved with the pendulum
    # dataset step, then profiled windows of 10 steps
    def dr_model():
        m, _ = build_pendulum_model(dr_cfg, spurious=True, device=dev, seed=0)
        return m, make_optimizer(m, LR)

    model, opt = dr_model()
    dr_step = make_train_step(model, opt, BETA, DR_LAM)
    dr_epoch = make_epoch_runner(dr_step, BATCH)
    model, opt = dr_model()
    online_run = {n: make_online_scanned_steps(
        model, opt, BETA, DR_LAM, BATCH, n, 64, sample_batch=sample, seed=1,
        device=dev) for n in (steps, 10)}
    model, opt = dr_model()
    semi_step = make_semi_step(model, opt, BETA, LAM)
    semi_epoch = make_scanned_epochs_semi(semi_step, BATCH, BATCH_L)
    n_l = int(len(dr_ds) * 0.1)
    x_l, y_l = dr_ds.x_data[:n_l], dr_ds.y_data[:n_l]

    def online_epoch(k):
        avg = Averager()
        avg.add(online_run[steps](k * steps))
        return avg.result()

    med = interleaved_ms({
        "dataset": dataset_epoch,
        "DR dataset": lambda k: dr_epoch(
            dr_ds.x_data, dr_ds.y_data,
            torch.Generator(device=dev).manual_seed(500 + k)),
        "DR online": online_epoch,
        "DR semi": lambda k: semi_epoch(
            dr_ds.x_data, x_l, y_l,
            torch.Generator(device=dev).manual_seed(600 + k))}, steps, card)
    gen = torch.Generator(device=dev).manual_seed(3)
    order = epoch_batches(len(dr_ds), BATCH, gen)[:10]
    profiled_steps("DR dataset step", lambda: [
        dr_step(dr_ds.x_data[i], dr_ds.y_data[i], generator=gen)
        for i in order], 10, med["DR dataset"])
    kernels = profiled_steps("DR online step", lambda: online_run[10](0), 10,
                             med["DR online"])
    render_us = sum(k.self_device_time_total for k in kernels
                    if "render_kernel" in k.key) / 10
    print(f"DR online step: render kernel {render_us:.2f} us device time a "
          f"step [{card}]")
    batches = list(zip(order, labeled_batches(n_l, 10, BATCH_L, gen)))
    profiled_steps("DR semi step", lambda: [
        semi_step(dr_ds.x_data[u], x_l[lb], y_l[lb], generator=gen)
        for u, lb in batches], 10, med["DR semi"])

    # the downstream evals: robustness on this phase's DR checkpoint,
    # sample efficiency on phase 8's, the toy experiment, and inference on
    # the DR checkpoint
    renderer_cuda.launches = 0
    rob_dir, se_dir = work / "robustness", work / "sample_efficiency"
    _, rob, rob_s = run_cli(["--checkpoint", str(dr_ckpt), "--repeats",
                             str(EVAL_REPEATS), "--epochs",
                             str(ROBUSTNESS_EPOCHS), "--assets_dir",
                             str(rob_dir)], "dr_robustness")
    check(0.0 <= rob["worst_group_accuracy"] <= rob["avg_accuracy"] <= 1.0,
          f"robustness {rob}")
    check(len(read_text_lines(rob_dir / "CDGVAE_linear_0.txt")) == 2,
          "dr_robustness did not write its two lines")
    _, se, se_s = run_cli(["--checkpoint", str(pendulum_ckpt), "--repeats",
                           str(EVAL_REPEATS), "--assets_dir", str(se_dir)],
                          "sample_efficiency")
    check(all(0.0 <= se[k] <= 1.0 for k in ("accuracy_100",
                                             "accuracy_all")),
          f"sample efficiency {se}")
    check(len(read_text_lines(se_dir / "CDGVAE_linear_0.txt")) == 3,
          "sample_efficiency did not write its three lines")
    _, toy, toy_s = run_cli([], "toy_dr")
    check(all(0.0 <= a <= 1.0 for pair in toy.values() for a in pair),
          f"toy_dr accuracies {toy}")
    _, grid, inf_s = run_cli(["--checkpoint", str(dr_ckpt), "--assets_dir",
                              str(work / "dr_inference")], "inference")
    check(grid.shape == (5, 7, 64, 64, 3) and np.isfinite(grid).all(),
          f"DR do grid {grid.shape}")
    path_launches["dr eval"] = renderer_cuda.launches
    check(path_launches["dr eval"] == 5, f"DR eval: "
          f"{path_launches['dr eval']} render launches, not 5 (robustness "
          "2, sample efficiency 2, inference 1)")
    print(f"downstream cli wall (host clock, dataset builds included): "
          f"dr_robustness --repeats {EVAL_REPEATS} --epochs "
          f"{ROBUSTNESS_EPOCHS} {rob_s:.3f} s (average "
          f"{rob['avg_accuracy']:.4f}, worst group "
          f"{rob['worst_group_accuracy']:.4f}); sample_efficiency --repeats "
          f"{EVAL_REPEATS} {se_s:.3f} s ({se}); toy_dr {toy_s:.3f} s; "
          f"inference on the DR checkpoint {inf_s:.3f} s; launches "
          f"{{'render': {path_launches['dr eval']}}} [{card}]")

    # a default run's fits: 10 repeats stacked, 7,500 train rows at batch
    # 64 (117 steps an epoch). The fit on the card (a CUDA graph an epoch)
    # against the CPU's eager steps from the same init and row orders, then
    # its set-up (warm-up step and capture) and its time a step, replayed
    n_rows, members = train_split_size(10000), 10
    g = torch.Generator(device=dev).manual_seed(0)
    reps = torch.randn((members, n_rows, 4), generator=g, device=dev)
    targets = (torch.rand((members, n_rows, 1), generator=g, device=dev)
               < torch.sigmoid(2 * reps[..., :1])).float()
    perms = torch.rand((2, members, n_rows), generator=g,
                       device=dev).argsort(dim=2)
    fits = {}
    for d in ("cpu", dev):
        init = DownstreamClassifier(4, members, generator=torch.Generator()
                                    .manual_seed(0), device=d)
        fits[d] = train_downstream(reps.to(d), targets.to(d), 0, epochs=2,
                                   batch_size=64, init=init,
                                   perms=perms.to(d)).trees()
    fit_err = max(float(np.abs(a["classify"][layer][k]
                               - b["classify"][layer][k]).max())
                  for a, b in zip(fits[dev], fits["cpu"])
                  for layer in ("layer0", "layer1") for k in ("w", "b"))
    print(f"downstream fit, 10 repeats x 2 epochs of {n_rows // 64} steps: "
          f"params cuda against cpu max |d| {fit_err:.3e} (limit "
          f"{FIT_TOL})")
    check(fit_err <= FIT_TOL, "the downstream fit on the card disagrees "
          "with the CPU")
    walls = {}
    for epochs in (1, 21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_downstream(reps, targets, 0, epochs=epochs, batch_size=64)
        torch.cuda.synchronize()
        walls[epochs] = time.perf_counter() - t0
    per_epoch = n_rows // 64
    step_s = (walls[21] - walls[1]) / (20 * per_epoch)
    setup_s = walls[1] - per_epoch * step_s
    rob_steps = 500 * per_epoch
    se_steps = 100 * (100 // 32) + 100 * per_epoch
    print(f"downstream fit: {step_s * 1e6:.2f} us a step of 10 stacked "
          f"repeats (host clock over 20 replayed epochs of {per_epoch}), "
          f"{setup_s * 1e3:.1f} ms of set-up a fit (warm-up step and "
          f"capture). At the defaults (10,000 samples, 10 repeats), "
          f"dr_robustness fits 500 epochs x {per_epoch} = {rob_steps} steps, "
          f"about {setup_s + rob_steps * step_s:.2f} s at these rates, and "
          f"renders 2 launches; sample_efficiency fits 100 x {100 // 32} + "
          f"100 x {per_epoch} = {se_steps} steps in two fits, about "
          f"{2 * setup_s + se_steps * step_s:.2f} s, and renders 2 launches "
          f"[{card}]")
    return max_err


def host_s(fn, rounds: int = 3) -> float:
    """Median host-clock seconds of ``rounds`` calls of host-only ``fn``."""
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def decode_and_load_pillow_tree(*, work: Path, card: str, dev, paths: list,
                                x_want: torch.Tensor) -> None:
    """The PNG decoder on the export's ``write_png`` files (filter 0 on
    every row) and on the same pixels re-encoded as Pillow filters them
    (Sub, Up and Paeth rows, which the decoder walks pixel by pixel), the
    two trees interleaved; the row loop alone on each tree's scanlines
    beside one copy of the filter-0 scanlines; then ``load_png_dataset`` of
    each tree again, whose images must equal ``x_want``, the ``write_png``
    tree's first load."""
    from cdgvae_torch.data import png_io

    pixels = png_io.decode_pngs([str(p) for p in paths])
    pil = work / "png_pillow" / "train"
    pil.mkdir(parents=True)
    kinds = np.zeros(5, np.int64)
    with ThreadPoolExecutor(max_workers=8) as pool:
        for i in range(0, len(paths), 500):
            scan = pillow_scanlines(np.stack(pixels[i:i + 500]))
            kinds += np.bincount(scan[:, :, 0].ravel(), minlength=5)
            list(pool.map(write_scanlines,
                          [pil / p.name for p in paths[i:i + 500]], scan))
    trees = {"write_png": [str(p) for p in paths],
             "Pillow": [str(pil / p.name) for p in paths]}
    decode = {name: [] for name in trees}
    for _ in range(2):
        for name, files in trees.items():
            t0 = time.perf_counter()
            got = png_io.decode_pngs(files)
            decode[name].append(time.perf_counter() - t0)
            check(all(np.array_equal(a, b) for a, b in zip(got, pixels)),
                  f"the {name} tree decodes to other pixels")
            del got
    rows = dict(zip(("None", "Sub", "Up", "Average", "Paeth"),
                    kinds.tolist()))
    n = len(paths)
    print(f"decode_pngs of {n} files at {EXPORT_PX} px (host clock, 2 "
          f"rounds interleaved): write_png's (filter 0) "
          f"{', '.join(f'{s:.3f}' for s in decode['write_png'])} s = "
          f"{n / min(decode['write_png']):.0f} files/s; Pillow's filters "
          f"(rows {rows}) {', '.join(f'{s:.3f}' for s in decode['Pillow'])}"
          f" s = {n / min(decode['Pillow']):.0f} files/s; pixels equal "
          f"[{card}]")
    scan = {name: np.stack([np.frombuffer(png_io._read_png(f)[1], np.uint8)
                            .reshape(EXPORT_PX, -1) for f in files])
            for name, files in trees.items()}
    loop0 = host_s(lambda: png_io._unfilter(scan["write_png"], 3))
    copy0 = host_s(lambda: scan["write_png"][:, :, 1:].copy())
    loop_pil = host_s(lambda: png_io._unfilter(scan["Pillow"], 3))
    print(f"unfilter alone, {n} files (host clock, median of 3): filter-0 "
          f"rows through the row loop {loop0 * 1e3:.1f} ms, one copy of "
          f"them {copy0 * 1e3:.1f} ms; Pillow's rows {loop_pil * 1e3:.1f} "
          f"ms [{card}]")
    del scan, pixels
    load = {}
    for name, files in trees.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _ = png_io.load_png_dataset(str(Path(files[0]).parent), 64,
                                       device=dev)
        torch.cuda.synchronize()
        load[name] = time.perf_counter() - t0
        check(torch.equal(x, x_want), f"the {name} tree loads to other "
              "images than its first load")
        del x
    print(f"load_png_dataset again ({n} files, {EXPORT_PX} -> 64 px, host "
          f"clock): write_png's tree {load['write_png']:.3f} s = "
          f"{n / load['write_png']:.0f} files/s; the Pillow-filtered tree "
          f"{load['Pillow']:.3f} s = {n / load['Pillow']:.0f} files/s; "
          f"images equal [{card}]")


def png_trees(*, work: Path, card: str, dev, path_launches: dict,
              clf_ckpt: Path, check_render, finite_falling) -> float:
    """Phase 15: the render kernel at the export's 96 px, ``cli.
    generate_data`` at its defaults (real) and at a cut ``--n`` (DR), the
    files held against ``render_reference``, then the CLIs on the trees:
    ``cli.main --data_dir`` (a 96 -> 64 px resize), ``cli.metric`` and
    ``cli.inference`` reading the tree from that checkpoint's config, and
    ``cli.dr_main --data_dir``. Adds the export's render launches to
    ``path_launches["png export"]``; returns the largest max |d| of its
    render checks."""
    from cdgvae_torch.data.pendulum import sample_factors_real
    from cdgvae_torch.data.pendulum_dr import sample_factors_dr
    from cdgvae_torch.data.png_io import (decode_pngs, load_png_dataset,
                                         sample_filename)
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.ops.renderer import render_reference
    from cdgvae_torch.utils.checkpoint import load_checkpoint

    # the kernel at 96 px on a chunk of the export, with and without the
    # DR background bit, into one buffer as the export renders
    factors, is_test = sample_factors_real(1, EXPORT_N)
    train_dr, _ = sample_factors_dr(1, EXPORT_N)
    n = min(EXPORT_CHUNK, len(train_dr))
    out = torch.empty((n, EXPORT_PX, EXPORT_PX, 3), device=dev)
    max_err = 0.0
    for name, f_np, bg_np in (("", factors[:n, :4], None),
                              (" DR bg", train_dr[:n, :4], train_dr[:n, 4])):
        f = torch.as_tensor(f_np, dtype=torch.float32, device=dev)
        bg = None if bg_np is None else torch.as_tensor(
            bg_np, dtype=torch.float32, device=dev)
        max_err = max(max_err, check_render(
            f"B={n} {EXPORT_PX}px{name}", renderer_cuda.render_cuda(
                f, EXPORT_PX, bg, out=out), f, EXPORT_PX, bg))
        k_ms = time_ms(lambda: renderer_cuda.render_cuda(f, EXPORT_PX, bg,
                                                         out=out))
        p_ms = time_ms(lambda: render_reference(f, EXPORT_PX, bg), reps=3,
                       rounds=3)
        b_ms, b_by = render_bound_ms(n, EXPORT_PX, background=bg is not None)
        print(f"render B={n} {EXPORT_PX}px{name} into one buffer: kernel "
              f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), {b_ms / k_ms:.3f} of the "
              f"bound [{card}]")

    # cli.generate_data: the real DGP at its defaults, then the DR DGP cut
    real, dr = work / "png_real", work / "png_dr"
    renderer_cuda.launches = 0
    # the defaults, spelled out
    said, (n_train, n_test), real_s = run_cli(
        ["--dgp", "real", "--n", str(EXPORT_N), "--image_size",
         str(EXPORT_PX), "--out", str(real)], "generate_data")
    real_launches = renderer_cuda.launches
    want = {split: len({sample_filename(r) for r in factors[sel]})
            for split, sel in (("train", ~is_test), ("test", is_test))}
    got = {split: len(list((real / split).iterdir()))
           for split in ("train", "test")}
    check(real_launches == -(-EXPORT_N // EXPORT_CHUNK) and got == want
          and (n_train, n_test) == (int((~is_test).sum()),
                                    int(is_test.sum())),
          f"generate_data real: {real_launches} render launches, files "
          f"{got}, expected {want}")
    renderer_cuda.launches = 0
    _, (dr_train, dr_test), dr_s = run_cli([
        "--dgp", "dr", "--n", str(EXPORT_DR_N), "--image_size",
        str(EXPORT_PX), "--out", str(dr)], "generate_data")
    path_launches["png export"] = real_launches + renderer_cuda.launches
    check(renderer_cuda.launches == 1 and dr_train + dr_test == EXPORT_DR_N,
          f"generate_data dr: {renderer_cuda.launches} launches, "
          f"{dr_train} + {dr_test} files")
    print(f"png export: generate_data --dgp real ({EXPORT_N} files, "
          f"{EXPORT_PX} px) {real_s:.3f} s = {EXPORT_N / real_s:.0f} files/s; "
          f"--dgp dr --n {EXPORT_DR_N} {dr_s:.3f} s = "
          f"{EXPORT_DR_N / dr_s:.0f} files/s (host clock); launches "
          f"{{'render': {path_launches['png export']}}} [{card}]")

    # the written files against render_reference of their file names'
    # factors, within one uint8 level
    names = sorted((real / "train").iterdir())[:64]
    pixels = np.stack(decode_pngs([str(p) for p in names]))
    labels = np.array([[float(v) for v in p.name[:-4].split("_")[1:]]
                       for p in names])
    ref = render_reference(torch.as_tensor(labels[:, :4], dtype=torch.float32,
                                           device=dev), EXPORT_PX)
    ref_u8 = torch.round(ref * 127.5 + 127.5).clamp(0, 255).cpu().numpy()
    level = float(np.abs(pixels.astype(np.float64) - ref_u8).max())
    print(f"64 exported files against render_reference of their names' "
          f"factors: max {level:.0f} uint8 level(s)")
    check(level <= 1.0, "the exported files disagree with render_reference")

    # the load alone (decode on the host, resize on the card), then the
    # CLIs on the trees; nothing renders on these paths
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y = load_png_dataset(str(real / "train"), 64, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(x.shape == (got["train"], 64, 64, 3) and y.shape[1] == 5
          and bool(torch.isfinite(x).all()), f"loaded tree {tuple(x.shape)}")
    print(f"load_png_dataset({got['train']} files, {EXPORT_PX} -> 64 px): "
          f"{load_s:.3f} s = {got['train'] / load_s:.0f} files/s (host "
          f"clock) [{card}]")
    decode_and_load_pillow_tree(work=work, card=card, dev=dev,
                                paths=sorted((real / "train").iterdir()),
                                x_want=x)
    del x, y
    tree_dir = work / "png_cli"
    ckpt = tree_dir / "model_CDGVAE_linear"
    renderer_cuda.launches = 0
    _, _, main_s = run_cli(["--data_dir", str(real), "--epochs", "2",
                            "--assets_dir", str(tree_dir)])
    cfg = load_checkpoint(str(ckpt))["config"]
    check(cfg["data_dir"] == str(real), f"checkpoint data_dir {cfg}")
    losses = finite_falling("main --data_dir",
                            read_records(tree_dir / "metrics.jsonl"))
    _, (lower, upper), metric_s = run_cli(
        ["--checkpoint", str(ckpt), "--classifier_checkpoint", str(clf_ckpt),
         "--assets_dir", str(work / "png_cdm")], "metric")
    for mat in (lower, upper):
        for s, c in STRUCTURAL_ZEROS:
            check(mat[s, c] == 0.0, f"CDM on the tree [{s}, {c}] = "
                  f"{mat[s, c]!r}")
    _, grid, inf_s = run_cli(["--checkpoint", str(ckpt), "--assets_dir",
                              str(work / "png_inference")], "inference")
    size = cfg["image_size"]
    check(grid.shape == (4, 7, size, size, 3) and np.isfinite(grid).all(),
          f"do grid on the tree {grid.shape}")
    dr_dir = work / "png_dr_cli"
    _, _, dr_main_s = run_cli(["--data_dir", str(dr), "--epochs", "1",
                               "--assets_dir", str(dr_dir)], "dr_main")
    dr_cfg = load_checkpoint(str(dr_dir / "model_DR_CDGVAE_linear"))["config"]
    dr_loss = [r["loss"] for r in read_records(dr_dir / "metrics.jsonl")]
    check(dr_cfg["data_dir"] == str(dr) and dr_cfg["spurious"] is True
          and len(dr_loss) == 1 and math.isfinite(dr_loss[0]),
          f"dr_main --data_dir: config {dr_cfg}, losses {dr_loss}")
    check(renderer_cuda.launches == 0, f"{renderer_cuda.launches} render "
          "launches on the PNG-tree paths, which load and render nothing")
    print(f"cli on the PNG trees (host clock, loads included): main "
          f"--data_dir 2 epochs {main_s:.3f} s, losses {losses}; metric "
          f"{metric_s:.3f} s (structural zeros exactly 0.0); inference "
          f"{inf_s:.3f} s; dr_main --data_dir 1 epoch {dr_main_s:.3f} s, loss "
          f"{dr_loss}; render launches 0 [{card}]")
    return max_err


def tabular(*, work: Path, card: str, dev, rng, profiled_steps) -> None:
    """Phase 16: the tabular family at its full synthetic sizes through
    ``cli.tabular_main`` (CDG-VAE 2 epochs and ``--resume`` to 3 on every
    dataset; VAE and InfoMax on loan and covtype; ``--eager`` on loan), the
    loss on the card against the CPU, host ms and device busy a step,
    ``cli.tabular_inference``, ``cli.dag_discovery`` and serving on the
    card against the CPU."""
    from cdgvae_torch.api import LoadedModel
    from cdgvae_torch.data.tabular.datasets import load_tabular
    from cdgvae_torch.factory import build_tabular_model
    from cdgvae_torch.train.scanned import epoch_batches, make_epoch_runner
    from cdgvae_torch.train.steps import make_optimizer
    from cdgvae_torch.train.tabular_steps import (make_recon_fn,
                                                  make_tabular_infomax_loss_fn,
                                                  make_tabular_loss_fn,
                                                  make_tabular_step)
    from cdgvae_torch.utils.checkpoint import load_checkpoint

    data = {ds: load_tabular(ds) for ds in TAB_STEPS}
    for ds, steps in TAB_STEPS.items():
        check(len(data[ds].x_data) // TAB_BATCH == steps,
              f"{ds}: {len(data[ds].x_data)} train rows")

    # cli.tabular_main on every dataset
    walls = {}
    for ds, steps in TAB_STEPS.items():
        runs = [("CDGVAE", [])]
        if ds in ("loan", "covtype"):
            runs += [("VAE", []), ("InfoMax", [])]
        if ds == "loan":
            runs.append(("CDGVAE", ["--eager"]))
        for model, extra in runs:
            out = work / f"tab_{ds}_{model}{'_eager' if extra else ''}"
            ckpt = out / f"tabular_{model}_{ds}"
            epochs = 2 if model == "CDGVAE" and not extra else 1
            args = ["--dataset", ds, "--model", model, *extra,
                    "--assets_dir", str(out)]
            _, _, s = run_cli(args + ["--epochs", str(epochs)],
                              "tabular_main")
            walls[f"{ds} {model}{' eager' if extra else ''}"] = s
            count = -(-len(data[ds].x_data) // TAB_BATCH) if extra else steps
            if epochs == 2:
                said, _, s = run_cli(args + ["--epochs", "3", "--resume",
                                             str(ckpt)], "tabular_main")
                check(f"resumed from {ckpt} at epoch 2" in said,
                      f"{ds}: no 'resumed' line")
                epochs = 3
            ck = load_checkpoint(str(ckpt))
            counts = [int(ck["opt_state"][0].count)]
            if model == "InfoMax":
                counts.append(int(ck["extras"]["opt_state_d"][0].count))
            records = read_records(out / "metrics.jsonl")
            check(ck["step"] == epochs and counts == [epochs * count]
                  * len(counts) and len(records) == epochs
                  and all(math.isfinite(v) for r in records
                          for v in r.values()),
                  f"tabular {ds} {model} {extra}: step {ck['step']}, Adam "
                  f"counts {counts}, records {records}")
            print(f"tabular_main {ds} {model} {' '.join(extra)}: {epochs} "
                  f"epochs of {count} steps, losses "
                  f"{[round(r['loss'], 4) for r in records]}")
    print("tabular_main walls (s, host clock, load included): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()) + f" [{card}]")

    # the full-width loss on the card against the CPU (same weights, batch,
    # noise and, for InfoMax, permutation)
    for ds in TAB_STEPS:
        d = data[ds]
        x = torch.as_tensor(d.x_data[:TAB_BATCH])
        y = torch.as_tensor(d.label[:TAB_BATCH])
        recon_fn = make_recon_fn(ds, d.flatten_topology)
        node = d.label.shape[1]
        noise = torch.as_tensor(rng.standard_normal((TAB_BATCH, node)),
                                dtype=torch.float32)
        perm = torch.as_tensor(rng.permutation(TAB_BATCH))
        for model_name in ("CDGVAE", "InfoMax"):
            result = {}
            for name, device in (("cpu", torch.device("cpu")),
                                 ("cuda", dev)):
                cfg = {"model": model_name, "dataset": ds, "scm": "linear"}
                m, disc = build_tabular_model(cfg, device=device, seed=0)
                if disc is None:
                    loss, _ = make_tabular_loss_fn(m, TAB_BETA, TAB_LAM,
                                                   recon_fn)(
                        x.to(device), y.to(device), noise=noise.to(device))
                else:
                    loss, _ = make_tabular_infomax_loss_fn(
                        m, disc, TAB_BETA, TAB_LAM, GAMMA, recon_fn)(
                        x.to(device), y.to(device), noise=noise.to(device),
                        perm=perm.to(device))
                result[name] = loss.item()
            rel = abs(result["cuda"] - result["cpu"]) / abs(result["cpu"])
            print(f"tabular {ds} {model_name} loss cuda {result['cuda']:.6f} "
                  f"cpu {result['cpu']:.6f} rel {rel:.2e}")
            check(rel <= 1e-5, f"tabular {ds} {model_name} loss on the card "
                  "disagrees with the CPU")

    # host time a step over whole epochs (the datasets in turn, 3 rounds
    # after a warm one, median) and a profiled window of 10 steps
    runs, per_step = {}, {ds: [] for ds in TAB_STEPS}
    for ds in TAB_STEPS:
        d = data[ds]
        m, _ = build_tabular_model({"model": "CDGVAE", "dataset": ds,
                                    "scm": "linear"}, device=dev, seed=0)
        step = make_tabular_step(m, make_optimizer(m, TAB_LR), TAB_BETA,
                                 TAB_LAM, make_recon_fn(
                                     ds, d.flatten_topology))
        runs[ds] = (step, make_epoch_runner(step, TAB_BATCH),
                    torch.as_tensor(d.x_data, device=dev),
                    torch.as_tensor(d.label, device=dev))
    for k in range(4):
        for ds, (_, run, x, y) in runs.items():
            t0 = time.perf_counter()
            run(x, y, torch.Generator(device=dev).manual_seed(700 + k))
            if k:
                per_step[ds].append((time.perf_counter() - t0)
                                    / TAB_STEPS[ds])
    for ds, (step, _, x, y) in runs.items():
        host = statistics.median(per_step[ds])
        print(f"host time a step, tabular {ds} CDG-VAE, epochs of "
              f"{TAB_STEPS[ds]} steps: "
              f"{', '.join(f'{v * 1e3:.3f}' for v in per_step[ds])} ms, "
              f"median {host * 1e3:.3f} ms [{card}]")
        gen = torch.Generator(device=dev).manual_seed(9)
        order = epoch_batches(len(x), TAB_BATCH, gen)[:10]
        profiled_steps(f"tabular {ds} CDG-VAE step", lambda: [
            step(x[i], y[i], generator=gen) for i in order], 10, host)
        total = 200 * TAB_STEPS[ds]
        print(f"a default tabular_main --dataset {ds} run: 200 epochs x "
              f"{TAB_STEPS[ds]} = {total} steps, about {total * host:.1f} s "
              f"of steps at this host rate [{card}]")

    # cli.tabular_inference on the CDG-VAE checkpoints, cli.dag_discovery
    for ds in ("loan", "covtype"):
        inf_dir = work / f"tab_inference_{ds}"
        _, res, inf_s = run_cli(["--checkpoint", str(
            work / f"tab_{ds}_CDGVAE" / f"tabular_CDGVAE_{ds}"),
            "--assets_dir", str(inf_dir)], "tabular_inference")
        check(res["SHD (Train)"] >= 0 and res["SHD (Sample)"] >= 0
              and all(math.isfinite(v) for k, v in res.items()
                      if isinstance(v, float))
              and (inf_dir / f"inference_CDGVAE_{ds}.txt").is_file(),
              f"tabular_inference {ds}: {res}")
        print(f"tabular_inference {ds}: {res}; {inf_s:.3f} s (host clock) "
              f"[{card}]")
    _, (g_raw, g_label), dag_s = run_cli(
        ["--dataset", "loan", "--assets_dir", str(work / "dag")],
        "dag_discovery")
    check(g_raw.shape == (5, 5) and g_label.shape == (3, 3)
          and (work / "dag" / "dag_raw_loan.png").is_file(),
          f"dag_discovery shapes {g_raw.shape} {g_label.shape}")
    print(f"dag_discovery --dataset loan: {dag_s:.3f} s (host clock) [{card}]")

    # serving the CDG-VAE checkpoints on the card against the CPU, the same
    # eps for generation; covtype's B is not topologically ordered, so the
    # do-operator refuses it (as the JAX package's does)
    serve_err = 0.0
    for ds in ("loan", "adult", "covtype"):
        ckpt = str(work / f"tab_{ds}_CDGVAE" / f"tabular_CDGVAE_{ds}")
        served = {"cuda": LoadedModel.load(ckpt, device=dev),
                  "cpu": LoadedModel.load(ckpt, device="cpu")}
        x = data[ds].x_data[:TAB_BATCH]
        node = data[ds].label.shape[1]
        eps = rng.standard_normal((TAB_BATCH, node)).astype(np.float32)
        requests = {"encode": lambda m: m.encode(x),
                    "reconstruct": lambda m: m.reconstruct(x),
                    "generate": lambda m: m.generate(eps)}
        if ds != "covtype":
            for j in range(node):
                requests[f"counterfactual do{j}"] = (
                    lambda m, j=j: m.counterfactual(x, j, 0.5))
        for name, req in requests.items():
            got, want = req(served["cuda"]), req(served["cpu"])
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"tabular serve {ds} {name}: {got.shape}")
            err = float(np.abs(got - want).max())
            serve_err = max(serve_err, err)
            check(err <= SERVE_TOL, f"tabular serve {ds} {name}: cuda "
                  f"against cpu max |d| {err} > {SERVE_TOL}")
    print(f"tabular serving (encode, reconstruct, generate, counterfactual "
          f"on loan and adult, batch {TAB_BATCH}): max |d| cuda against cpu "
          f"{serve_err:.3e} (limit {SERVE_TOL})")


def tvae(*, work: Path, card: str, dev, rng, profiled_steps) -> None:
    """Phase 17: the CDG-TVAE at its full synthetic sizes (see the module
    docstring)."""
    from cdgvae_torch.api import LoadedModel
    from cdgvae_torch.cli.tabular_main_tvae import TRANSFORMER_RANDOM_STATE
    from cdgvae_torch.data.tabular.datasets import (DATASET_SPECS,
                                                    load_tabular_tvae)
    from cdgvae_torch.data.tabular.transformer import DataTransformer
    from cdgvae_torch.factory import build_tabular_model, tvae_block_mask
    from cdgvae_torch.train.scanned import epoch_batches, make_epoch_runner
    from cdgvae_torch.train.steps import make_optimizer
    from cdgvae_torch.train.tabular_steps import (make_sigma_clamp,
                                                  make_tvae_loss_fn,
                                                  make_tvae_step)
    from cdgvae_torch.utils.checkpoint import load_checkpoint
    from cdgvae_torch.utils.profiling import (TRACE_STEPS, newest_trace,
                                              rank_ops)

    # the transformer's fit and transform on the host, at full size
    data = {}
    for ds, steps in TVAE_STEPS.items():
        spec = DATASET_SPECS[ds]
        data[ds] = d = load_tabular_tvae(
            ds, random_state=TRANSFORMER_RANDOM_STATE[ds])
        check(len(d.x_data) // TAB_BATCH == steps,
              f"TVAE {ds}: {len(d.x_data)} rows")
        t0 = time.perf_counter()
        t = DataTransformer().fit(d.raw, discrete_columns=spec["discrete"],
                                  random_state=TRANSFORMER_RANDOM_STATE[ds])
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = t.transform(d.raw)
        transform_s = time.perf_counter() - t0
        check(t.output_info_list == d.transformer.output_info_list
              and np.array_equal(x.astype(np.float32), d.x_data),
              f"TVAE {ds}: a second fit and transform differ")
        print(f"TVAE transformer {ds}: {len(d.x_data)} rows x "
              f"{len(d.raw)} columns -> output_dimensions "
              f"{t.output_dimensions} (spans "
              f"{[[s.dim for s in col] for col in t.output_info_list]}); "
              f"fit {fit_s * 1e3:.1f} ms, transform "
              f"{transform_s * 1e3:.1f} ms (host clock) [{card}]")

    # cli.tabular_main_tvae on every dataset; on loan --resume, --eager and
    # --profile
    walls = {}
    for ds, steps in TVAE_STEPS.items():
        runs = [("fixed", [], 2)]
        if ds == "loan":
            runs += [("eager", ["--eager"], 1),
                     ("profile", ["--profile", str(work / "tvae_trace")],
                      2)]
        for name, extra, epochs in runs:
            out = work / f"tvae_{ds}_{name}"
            ckpt = out / f"tabular_TVAE_{ds}"
            args = ["--dataset", ds, *extra, "--assets_dir", str(out)]
            said, _, walls[f"{ds} {name}"] = run_cli(
                args + ["--epochs", str(epochs)], "tabular_main_tvae")
            count = -(-len(data[ds].x_data) // TAB_BATCH) if name == \
                "eager" else steps
            if name == "fixed" and ds == "loan":
                said, _, walls["loan resume"] = run_cli(
                    args + ["--epochs", "3", "--resume", str(ckpt)],
                    "tabular_main_tvae")
                check(f"resumed from {ckpt} at epoch 2" in said,
                      "TVAE loan: no 'resumed' line")
                epochs = 3
            ck = load_checkpoint(str(ckpt))
            records = read_records(out / "metrics.jsonl")
            sigma = ck["params"]["sigma"]
            check(sorted(p.name for p in ckpt.iterdir()) ==
                  ["config.json", "state.pkl", "transformer.npz"]
                  and ck["step"] == epochs
                  and int(ck["opt_state"][1].count) == epochs * count
                  and len(records) == epochs
                  and all(math.isfinite(v) for r in records
                          for v in r.values())
                  and sigma.min() >= np.float32(TVAE_SIGMA[0])
                  and sigma.max() <= np.float32(TVAE_SIGMA[1]),
                  f"tabular_main_tvae {ds} {name}: step {ck['step']}, "
                  f"records {records}, sigma {sigma.min()}..{sigma.max()}")
            print(f"tabular_main_tvae {ds} {name}: {epochs} epochs of "
                  f"{count} steps, losses "
                  f"{[round(r['loss'], 4) for r in records]}, sigma in "
                  f"[{sigma.min():.4f}, {sigma.max():.4f}]")
    ranked = rank_ops(str(work / "tvae_trace"), top=8)
    check(len(ranked) > 0, "the --profile trace holds no CUDA kernel")
    events = newest_trace(str(work / "tvae_trace"))["traceEvents"]
    traced = sum(ev.get("cat") == "user_annotation"
                 and ev.get("name", "").startswith("Optimizer.step")
                 for ev in events)
    replays = sum(ev.get("name", "").startswith("cudaGraphLaunch")
                  for ev in events)
    # the graphed epochs: the first step runs eagerly, its capture runs the
    # Python of a step once more, and every later step of the window is a
    # graph replay: the window holds its TRACE_STEPS steps
    check(traced == 2 and replays == TRACE_STEPS - 1,
          f"the --profile trace holds {traced} optimizer steps and "
          f"{replays} graph replays of {2 * TVAE_STEPS['loan']} steps, not "
          f"the eager first step, its capture and {TRACE_STEPS - 1} replays "
          f"(its window of {TRACE_STEPS})")
    print(f"tabular_main_tvae --profile: {traced} optimizer steps (the "
          f"eager first step and the capture) and {replays} graph replays "
          f"traced of {2 * TVAE_STEPS['loan']} steps; wall "
          f"{walls['loan profile']:.3f} s against {walls['loan fixed']:.3f} s "
          f"unprofiled (host clock, fit included) [{card}]")
    print("tabular_main_tvae --profile: top CUDA kernels of the trace "
          "(total ms): " + "; ".join(f"{n[:60]} {ms:.3f}"
                                     for n, ms in ranked))
    print("tabular_main_tvae walls (s, host clock, transformer fit "
          "included): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    walls.items()) + f" [{card}]")

    # the TVAE loss on the card against the CPU (same weights, batch and
    # noise, TF32 off)
    configs = {}
    for ds, d in data.items():
        spans = d.transformer.output_info_list
        configs[ds] = {"model": "TVAE", "dataset": ds, "scm": "linear",
                       "input_dim": d.transformer.output_dimensions,
                       "tvae_mask": tvae_block_mask(ds, spans)}
        x = torch.as_tensor(d.x_data[:TAB_BATCH])
        y = torch.as_tensor(d.label[:TAB_BATCH])
        noise = torch.as_tensor(rng.standard_normal((TAB_BATCH,
                                                     y.shape[1])),
                                dtype=torch.float32)
        result = {}
        for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            m, _ = build_tabular_model(dict(configs[ds]), device=device,
                                       seed=0)
            loss, _ = make_tvae_loss_fn(m, TVAE_LAM, spans)(
                x.to(device), y.to(device), noise=noise.to(device))
            result[name] = loss.item()
        rel = abs(result["cuda"] - result["cpu"]) / abs(result["cpu"])
        print(f"TVAE {ds} loss cuda {result['cuda']:.6f} cpu "
              f"{result['cpu']:.6f} rel {rel:.2e}")
        check(rel <= 1e-5, f"TVAE {ds} loss on the card disagrees with "
              "the CPU")

    # serving in data space on the card against the CPU: the same rows,
    # eps and global numpy seed for the sigma draws
    encode_err, column_err = 0.0, 0.0
    for ds, d in data.items():
        ckpt = str(work / f"tvae_{ds}_fixed" / f"tabular_TVAE_{ds}")
        served = {"cuda": LoadedModel.load(ckpt, device=dev),
                  "cpu": LoadedModel.load(ckpt, device="cpu")}
        x = d.x_data[:TAB_BATCH]
        eps = rng.standard_normal((TAB_BATCH, d.label.shape[1])).astype(
            np.float32)
        got, want = served["cuda"].encode(x), served["cpu"].encode(x)
        encode_err = max(encode_err, float(np.abs(got - want).max()))
        check(encode_err <= SERVE_TOL, f"TVAE serve {ds} encode: cuda "
              f"against cpu max |d| {encode_err}")
        t = served["cpu"].transformer
        requests = {"reconstruct": lambda m: m.reconstruct(x),
                    "generate": lambda m: m.generate(eps)}
        if ds != "covtype":
            requests["counterfactual do1"] = (
                lambda m: m.counterfactual(x, 1, 0.5))
        for name, req in requests.items():
            answers = {}
            for key in ("cuda", "cpu"):
                np.random.seed(17)
                answers[key] = req(served[key])
            got, want = answers["cuda"], answers["cpu"]
            check(got.columns == want.columns == t.columns
                  and got.shape == want.shape and np.isfinite(got).all(),
                  f"TVAE serve {ds} {name}: {got.shape} {got.columns}")
            for j, info in enumerate(t._column_transform_info_list):
                g, w = np.asarray(got)[:, j], np.asarray(want)[:, j]
                if (info.column_type == "discrete"
                        or t._column_raw_dtypes[info.column_name].kind
                        in "iu"):
                    check(np.array_equal(g, w), f"TVAE serve {ds} {name} "
                          f"{info.column_name}: not equal on the card")
                    continue
                scale = 4 * float(info.transform._components()[1].max())
                err = float(np.abs(g - w).max()) / scale
                column_err = max(column_err, err)
                check(err <= TVAE_COLUMN_TOL, f"TVAE serve {ds} {name} "
                      f"{info.column_name}: max |d| {err} x 4 sigma")
    print(f"TVAE serving (encode; reconstruct, generate and, on loan and "
          f"adult, counterfactual in data space, batch {TAB_BATCH}): encode "
          f"max |d| {encode_err:.3e} (limit {SERVE_TOL}); float columns "
          f"max |d| {column_err:.3e} x 4 sigma (limit {TVAE_COLUMN_TOL}); "
          f"integer and discrete columns equal")

    # host time a step over whole epochs (the datasets in turn, 3 rounds
    # after a warm one, median) and a profiled window of 10 steps each
    runs, per_step = {}, {ds: [] for ds in data}
    for ds, d in data.items():
        m, _ = build_tabular_model(dict(configs[ds]), device=dev, seed=0)
        step = make_tvae_step(m, make_optimizer(m, TVAE_LR,
                                                weight_decay=TVAE_WD),
                              TVAE_LAM, d.transformer.output_info_list)
        clamp = make_sigma_clamp(m, TVAE_SIGMA)
        runs[ds] = (step, clamp, make_epoch_runner(step, TAB_BATCH,
                                                   post_update=clamp),
                    torch.as_tensor(d.x_data, device=dev),
                    torch.as_tensor(d.label, device=dev))
    for k in range(4):
        for ds, (_, _, run, x, y) in runs.items():
            t0 = time.perf_counter()
            run(x, y, torch.Generator(device=dev).manual_seed(800 + k))
            if k:
                per_step[ds].append((time.perf_counter() - t0)
                                    / TVAE_STEPS[ds])
    for ds, (step, clamp, _, x, y) in runs.items():
        host = statistics.median(per_step[ds])
        print(f"host time a step, TVAE {ds}, epochs of {TVAE_STEPS[ds]} "
              f"steps: {', '.join(f'{v * 1e3:.3f}' for v in per_step[ds])} "
              f"ms, median {host * 1e3:.3f} ms [{card}]")
        gen = torch.Generator(device=dev).manual_seed(9)
        order = epoch_batches(len(x), TAB_BATCH, gen)[:10]
        profiled_steps(f"TVAE {ds} step (and sigma clamp)", lambda: [
            (step(x[i], y[i], generator=gen), clamp()) for i in order],
            10, host)
        total = 300 * TVAE_STEPS[ds]
        print(f"a default tabular_main_tvae --dataset {ds} run: 300 epochs "
              f"x {TVAE_STEPS[ds]} = {total} steps, about {total * host:.1f}"
              f" s of steps at this host rate [{card}]")

    # cli.tabular_inference_tvae on each checkpoint
    for ds in data:
        inf_dir = work / f"tvae_inference_{ds}"
        said, res, inf_s = run_cli(["--checkpoint", str(
            work / f"tvae_{ds}_fixed" / f"tabular_TVAE_{ds}"),
            "--assets_dir", str(inf_dir)], "tabular_inference_tvae")
        lines = read_text_lines(inf_dir / f"inference_TVAE_{ds}.txt")
        score = [v for k, v in res.items() if k.endswith("(Synthetic)")]
        check(res["SHD (Sample)"] >= 0 and len(score) == 1
              and math.isfinite(score[0])
              and lines[0] == f"SHD (Sample): {res['SHD (Sample)']}",
              f"tabular_inference_tvae {ds}: {res}")
        print(f"tabular_inference_tvae {ds}: {lines}; {inf_s:.3f} s (host "
              f"clock) [{card}]")


def celeba_forward_flops(model, batch: int) -> dict:
    """Operations (2 a multiply-add) of one forward of the CelebA CDG-VAE
    at ``batch``, from its shapes: the convs of the ResNet-18 trunk, its fc
    head, and each generator's SN linear, convs, attention convs and
    attention products. Elementwise work (BatchNorm, activations, noise,
    masks) and the SN sigma products are left out."""
    B, S = batch, model.image_size

    def conv(hw, k, cin, cout):
        return 2 * B * hw * hw * k * k * cin * cout

    def half(s):
        return -(-s // 2)

    # stem 7x7/2, max-pool /2, then 4 stages of 2 basic blocks
    s = half(S)
    trunk, s, cin = conv(s, 7, 3, 64), half(s), 64
    for li, width in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            if li > 0 and bi == 0:
                s = half(s)
            trunk += conv(s, 3, cin, width) + conv(s, 3, width, width)
            if cin != width:
                trunk += conv(s, 1, cin, width)
            cin = width
    head = 2 * B * 512 * (2 * model.node + 2 * model.latent_dim)
    gen = model.decoder["gen0"]
    decoder = 0
    for zd in model.z_dims:
        decoder += 2 * B * zd * gen.blocks[0][0] * 16
        s = 4
        for i, (ci, co) in enumerate(gen.blocks):
            s *= 2
            decoder += conv(s, 3, ci, co) + conv(s, 3, co, co) \
                + conv(s, 1, ci, co)
            if i == gen.attn_after:  # theta, phi, g, attn; two products
                hw = s * s
                decoder += 2 * B * hw * (co * co // 8 * 2 + co * co // 2
                                         + co // 2 * co)
                decoder += 2 * B * hw * (hw // 4) * (co // 8 + co // 2)
        decoder += conv(S, 3, gen.bn.scale.numel(), 3)
    return {"trunk": trunk, "head": head, "decoder": decoder}


def celeba(*, work: Path, card: str, dev, profiled_steps) -> None:
    """Phase 18: the CelebA family at cli.celeba_main's defaults (see the
    module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from cdgvae_torch.api import LoadedModel
    from cdgvae_torch.cli.celeba_main import get_args
    from cdgvae_torch.data.celeba import synthetic_celeba
    from cdgvae_torch.factory import build_celeba_model
    from cdgvae_torch.models.sagan import sn_refresh
    from cdgvae_torch.train.celeba_steps import (make_celeba_loss_fn,
                                                 make_celeba_step)
    from cdgvae_torch.train.scanned import epoch_batches
    from cdgvae_torch.train.steps import make_optimizer
    from cdgvae_torch.utils.checkpoint import load_checkpoint
    from cdgvae_torch.utils.profiling import newest_trace, rank_ops

    config = vars(get_args([]))  # the defaults
    check(config["img_size"] == 128 and config["conv_dim"] == 32
          and config["batch_size"] == CELEBA_BATCH,
          f"celeba_main's defaults moved: {config}")
    host_model = build_celeba_model(config, device="cpu")
    n_params = sum(p.numel() for p in host_model.parameters())
    n_sn = sum(b.numel() for n, b in host_model.named_buffers()
               if n.endswith((".u", ".v")))
    del host_model

    # cli.celeba_main: 2 epochs with a checkpoint each, --resume to 3, then
    # one run a flag
    out, walls = work / "celeba", {}
    ckpt = out / "celeba_CDGVAE_linear"
    trace_dir = work / "celeba_trace"
    bf16_out = work / "celeba_bf16"
    bf16_ckpt = bf16_out / "celeba_CDGVAE_linear"
    runs = [("fixed", ["--ckpt_every", "1"], 2, out),
            ("resume", ["--resume", str(ckpt)], 3, out),
            ("uninterrupted", [], 3, None),
            ("eager", ["--eager"], 1, None),
            ("bf16", ["--bf16", "--ckpt_every", "1"], 2, bf16_out),
            ("bf16 resume", ["--bf16", "--resume", str(bf16_ckpt)], 3,
             bf16_out),
            ("bf16 uninterrupted", ["--bf16"], 3, None),
            ("train_trunk", ["--train_trunk"], 1, None),
            ("align_warmup", ["--align_warmup", "1"], 2, None),
            ("stacked_decoder", ["--stacked_decoder", "true"], 1, None),
            ("async_ckpt", ["--async_ckpt", "true", "--ckpt_every", "1"], 2,
             None),
            ("profile", ["--profile", str(trace_dir)], 2, None)]
    for name, extra, epochs, run_dir in runs:
        run_dir = run_dir or work / f"celeba_{name.replace(' ', '_')}"
        said, _, walls[name] = run_cli(
            ["--epochs", str(epochs), "--assets_dir", str(run_dir), *extra],
            "celeba_main")
        ck = load_checkpoint(str(run_dir / "celeba_CDGVAE_linear"))
        records = read_records(run_dir / "metrics.jsonl")
        check(ck["step"] == epochs
              and int(ck["opt_state"][0].count) == epochs * CELEBA_STEPS
              and len(records) == epochs
              and all(math.isfinite(v) for r in records
                      for v in r.values()),
              f"celeba_main {name}: step {ck['step']}, count "
              f"{ck['opt_state'][0].count}, records {records}")
        if name == "fixed":
            check((run_dir / "tmp_image_0.png").exists()
                  and (run_dir / "tmp_image_1.png").exists(),
                  "celeba_main: no tmp_image_{0,1}.png")
        if name.endswith("resume"):
            check(f"resumed from {run_dir / 'celeba_CDGVAE_linear'} at "
                  f"epoch 2" in said, f"celeba_main {name}: no 'resumed' "
                  "line")
        if name.endswith("uninterrupted"):
            # --resume to 3 equals the uninterrupted 3 epochs bit for bit
            # (cuDNN's deterministic algorithms, which celeba_main sets)
            resumed = load_checkpoint(str((bf16_out if "bf16" in name
                                           else out)
                                          / "celeba_CDGVAE_linear"))
            la, lb = flat_leaves(resumed["params"]), flat_leaves(
                ck["params"])
            check(len(la) == len(lb) > 0, f"celeba_main {name}: the "
                  "checkpoints' params differ in layout")
            drift = max(float(np.abs(np.asarray(a, np.float64)
                                     - np.asarray(b, np.float64)).max())
                        for a, b in zip(la, lb))
            print(f"celeba_main {name.replace('uninterrupted', 'resume')} "
                  f"2 -> 3 against {name} 3 epochs: params max |d| "
                  f"{drift:.3e}; cuDNN deterministic "
                  f"{torch.backends.cudnn.deterministic} [{card}]")
            check(drift == 0.0, f"celeba_main --resume differs from the "
                  f"uninterrupted run ({name}): max |d| {drift}")
        if name == "align_warmup":
            check(abs(records[0]["loss"] - 5 * records[0]["alignment"])
                  <= 1e-4 * records[0]["loss"],
                  f"--align_warmup: epoch 1 is not lambda * align: "
                  f"{records[0]}")
        if name == "stacked_decoder":
            check(set(ck["params"]["decoder"]) == {"stacked"},
                  "--stacked_decoder true wrote no decoder.stacked")
        if name == "train_trunk":
            check(bool(np.abs(ck["opt_state"][0].mu["encoder"]["stem_conv"]
                              ["w"]).max() > 0), "--train_trunk: no moments")
        print(f"celeba_main {name}: {epochs} epochs of {CELEBA_STEPS} "
              f"steps, losses {[round(r['loss'], 2) for r in records]}, "
              f"active {[r['active'] for r in records]}; {walls[name]:.3f} s "
              f"(host clock, model init and checkpoint writes included) "
              f"[{card}]")
    ranked = rank_ops(str(trace_dir), top=8)
    events = newest_trace(str(trace_dir))["traceEvents"]
    traced = sum(ev.get("cat") == "user_annotation"
                 and ev.get("name", "").startswith("Optimizer.step")
                 for ev in events)
    replays = sum(ev.get("name", "").startswith("cudaGraphLaunch")
                  for ev in events)
    # the graphed epochs: the first step runs eagerly, its capture runs the
    # Python of a step once more, and every later step is a graph replay
    check(ranked and traced == 2 and replays == 2 * CELEBA_STEPS - 1,
          f"celeba_main --profile: {traced} optimizer steps and {replays} "
          f"graph replays traced")
    print(f"celeba_main --profile: {traced} optimizer steps (the eager "
          f"first step and the capture) and {replays} graph replays "
          f"traced of {2 * CELEBA_STEPS} steps")
    print("celeba_main --profile: top CUDA kernels of the trace (total "
          "ms): " + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in ranked))

    # the full-width loss on the card against the CPU: same weights, batch
    # and draws (a CPU generator draws for both), TF32 off
    x_np, y_np = synthetic_celeba(64, config["img_size"], seed=config["seed"])
    x16, y16 = (torch.as_tensor(a[:CELEBA_BATCH]) for a in (x_np, y_np))
    result = {}
    for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        m = build_celeba_model(config, device=device, seed=0)
        loss, _ = make_celeba_loss_fn(m, CELEBA_BETA, CELEBA_LAM)(
            x16.to(device), y16.to(device),
            generator=torch.Generator().manual_seed(3))
        result[name] = loss.item()
        if name == "cuda":
            with FlopCounterMode(display=False) as counter:
                with torch.no_grad():
                    m(x16.to(device))
            flops = celeba_forward_flops(m, CELEBA_BATCH)
        del m
    rel = abs(result["cuda"] - result["cpu"]) / abs(result["cpu"])
    print(f"CelebA loss (batch {CELEBA_BATCH}, {config['img_size']} px, "
          f"conv_dim {config['conv_dim']}, {n_params:,} parameters and "
          f"{n_sn:,} SN u/v entries) cuda "
          f"{result['cuda']:.6f} cpu "
          f"{result['cpu']:.6f} rel {rel:.2e}")
    check(rel <= 1e-5, "the CelebA loss on the card disagrees with the CPU")
    counted = counter.get_total_flops()
    fwd = sum(flops.values())
    print(f"CelebA forward at batch {CELEBA_BATCH}: {fwd / 1e9:.3f} GFLOP "
          f"counted from the shapes (trunk {flops['trunk'] / 1e9:.3f}, "
          f"decoder {flops['decoder'] / 1e9:.3f}); torch's FlopCounterMode "
          f"{counted / 1e9:.3f} GFLOP")
    check(abs(counted - fwd) <= 0.01 * counted,
          "the FLOP count disagrees with FlopCounterMode")
    # a step with the frozen trunk: its forward, and forward plus the
    # backward's two products (input and weight gradients) elsewhere
    step_flops = flops["trunk"] + 3 * (flops["head"] + flops["decoder"])

    # serving: the fixed run's checkpoint on the card against the CPU
    served = {"cuda": LoadedModel.load(str(ckpt), device=dev),
              "cpu": LoadedModel.load(str(ckpt), device="cpu")}
    serve_err = {}
    for b in (1, CELEBA_BATCH):
        xb = x_np[:b]
        requests = {"encode": lambda m: m.encode(xb),
                    "reconstruct": lambda m: m.reconstruct(xb),
                    "counterfactual do0": lambda m: m.counterfactual(
                        xb, 0, 0.5)}
        for name, req in requests.items():
            got, want = req(served["cuda"]), req(served["cpu"])
            err = float(np.abs(got - want).max())
            serve_err[f"{name} b{b}"] = err
            check(got.shape == want.shape and np.isfinite(got).all()
                  and err <= SERVE_TOL, f"CelebA serve {name} at batch {b}: "
                  f"max |d| {err} against the CPU")
            ms = time_ms(lambda: req(served["cuda"]), reps=3, rounds=3)
            print(f"CelebA serve {name} batch {b}: {ms:.3f} ms a request "
                  f"(CUDA events), max |d| {err:.3e} against the CPU "
                  f"[{card}]")
    del served

    # host ms a step (f32 and bf16 in turn, epochs of 4 steps, 2 a round)
    # and the device's busy share over a profiled window of 10 steps
    x_all = torch.as_tensor(x_np, device=dev)
    y_all = torch.as_tensor(y_np, device=dev)
    steppers = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        m = build_celeba_model(config, device=dev, seed=0)
        step = make_celeba_step(m, make_optimizer(m, CELEBA_LR),
                                CELEBA_BETA, CELEBA_LAM, compute_dtype=dtype)
        steppers[name] = (step, lambda m=m: sn_refresh(m))

    def epochs_of(name, k, n=2):
        step, refresh = steppers[name]
        gen = torch.Generator(device=dev).manual_seed(1000 + k)
        for _ in range(n):
            for idx in epoch_batches(64, CELEBA_BATCH, gen):
                step(x_all[idx], y_all[idx], generator=gen)
                refresh()
        torch.cuda.synchronize()

    host = interleaved_ms({f"CelebA {name}": (lambda k, name=name:
                                              epochs_of(name, k))
                           for name in steppers}, 2 * CELEBA_STEPS, card)
    for name in steppers:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        epochs_of(name, 50, n=1)
        peak = torch.cuda.max_memory_allocated()
        step, refresh = steppers[name]
        gen = torch.Generator(device=dev).manual_seed(77)
        order = torch.cat([epoch_batches(64, CELEBA_BATCH, gen)
                           for _ in range(3)])[:10]
        host_s = host[f"CelebA {name}"]
        ten_steps = (lambda: [(step(x_all[i], y_all[i], generator=gen),
                               refresh()) for i in order])
        kernels = profiled_steps(f"CelebA {name} step (and SN refresh)",
                                 ten_steps, 10, host_s)
        busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6 / 10
        # where the host's time goes: the same 10 steps, host ops only
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ten_steps()
            torch.cuda.synchronize()
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        host_ms = sum(e.self_cpu_time_total for e in ops) / 1e3 / 10
        print(f"CelebA {name}: {sum(e.count for e in kernels) / 10:.0f} "
              f"kernels a step; host ops (profiled) {host_ms:.3f} ms a step, "
              f"top by self time (ms a step, calls a step): " + "; ".join(
                  f"{e.key[:40]} {e.self_cpu_time_total / 1e4:.3f} "
                  f"({e.count / 10:.0f})" for e in ops[:8]) + f" [{card}]")
        peak_ops = PEAK_F32_OPS_PER_S if name == "f32" \
            else PEAK_BF16_OPS_PER_S
        print(f"CelebA {name}: {step_flops / 1e12:.4f} TFLOP a step "
              f"(counted); host {host_s * 1e3:.3f} ms a step -> "
              f"{step_flops / host_s / 1e12:.2f} TFLOP/s, "
              f"{step_flops / host_s / peak_ops:.4f} of the "
              f"{peak_ops / 1e12:.0f} TFLOP/s {name} peak; device busy "
              f"{busy_s * 1e3:.3f} ms a step -> "
              f"{step_flops / busy_s / 1e12:.2f} TFLOP/s while busy, busy "
              f"share {busy_s / host_s:.3f}; peak memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the {base / 2**30:.3f} GiB held before the epoch) "
              f"[{card}]")
    total = config["epochs"] * CELEBA_STEPS
    print(f"a default celeba_main run on the synthetic faces: "
          f"{config['epochs']} epochs x {CELEBA_STEPS} = {total} steps, "
          f"about {total * host['CelebA f32']:.1f} s of steps at this rate "
          f"[{card}]")
    print("celeba_main walls (s, host clock): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()) + f" [{card}]")


def data_parallel(*, work: Path, card: str, dev, dataset, ckpt: Path,
                  path_launches: dict) -> None:
    """Phase 19: data parallelism on the card in a world-1 NCCL group (see
    the module docstring)."""
    import tempfile

    from cdgvae_torch.api import LoadedModel
    from cdgvae_torch.cli.celeba_main import get_args as celeba_args
    from cdgvae_torch.data.celeba import synthetic_celeba
    from cdgvae_torch.factory import build_celeba_model, build_pendulum_model
    from cdgvae_torch.models.sagan import sn_refresh
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.parallel import make_mesh, process_group, replicate
    from cdgvae_torch.parallel.mesh import GradBuffer
    from cdgvae_torch.parallel.dryrun import dryrun_multichip
    from cdgvae_torch.train.celeba_steps import make_celeba_step
    from cdgvae_torch.train.loop import run_epochs
    from cdgvae_torch.train.online import (make_online_run_from_loss,
                                           pendulum_batch_fn,
                                           train_split_size)
    from cdgvae_torch.train.scanned import (Averager, make_epoch_runner,
                                            make_supervised_loss_fn)
    from cdgvae_torch.train.steps import make_optimizer, make_train_step
    from cdgvae_torch.utils.interop import export_params

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    def same(a: dict, b: dict) -> tuple[bool, float]:
        """Bit-equal params, and the largest |d|."""
        fa, fb = dict(flat(a)), dict(flat(b))
        check(fa.keys() == fb.keys(), "param trees differ in their leaves")
        worst = max(float(np.abs(fa[k].astype(np.float64)
                                 - fb[k].astype(np.float64)).max())
                    for k in fa)
        return all(np.array_equal(fa[k], fb[k]) for k in fa), worst

    def allreduce_window(name, params, mesh, size_mb):
        """The gradient mean (the NCCL all_reduce of the flat gradient
        buffer and its division) a step: its time on CUDA events, host
        enqueue included and not, and its device time and kernels over 10
        profiled calls."""
        grads = GradBuffer(params, mesh)
        ev_ms = time_ms(grads.mean)
        print(f"dp {name}: gradient mean over one {size_mb:.2f} MB float32 "
              f"buffer: {ev_ms * 1e3:.2f} us a call (CUDA events), "
              f"{device_ms(grads.mean) * 1e3:.2f} us of device time a call "
              f"(CUDA events, the calls queued behind a sleeping kernel) "
              f"[{card}]")
        busy, wall, table, kernels, _ = profile_window(
            lambda: [grads.mean() for _ in range(10)])
        if not kernels:
            print(f"dp {name}: the profiler saw no device kernels in its "
                  "window: device time not measured by it")
            return
        nccl = sum(e.self_device_time_total for e in kernels
                   if "nccl" in e.key.lower()) * 1e-6 / 10
        print(f"dp {name}: profiled 10 calls: {busy / 10 * 1e6:.2f} us "
              f"device time a step (NCCL's own kernels {nccl * 1e6:.2f} "
              f"us), {wall / 10 * 1e6:.2f} us wall a call [{card}]")
        print(table)

    t0 = time.perf_counter()
    x, y = dataset.x_data, dataset.y_data
    steps = len(x) // BATCH
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_")) / "store"
    with process_group(0, 1, "cuda", str(store)) as mesh:
        check(mesh.backend == "nccl" and mesh.size == 1,
              f"not a world-1 NCCL group: {mesh}")

        # the flagship through the sharded epoch runner against the
        # one-device runner: 2 epochs, bit for bit
        runs = {}
        for name, m in (("one device", None), ("dp world 1", mesh)):
            model, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
            if m is not None:
                replicate(m, model)
            opt = make_optimizer(model, LR)
            step = make_train_step(model, opt, BETA, LAM, mesh=m)
            hist = run_epochs(step, x, y, seed=1, epochs=2, batch_size=BATCH,
                              mesh=m)
            runs[name] = (hist, export_params(model), model, step)
        equal, worst = same(runs["one device"][1], runs["dp world 1"][1])
        print(f"dp flagship, 2 epochs of {steps} steps: sharded runner "
              f"losses {[h['loss'] for h in runs['dp world 1'][0]]}, "
              f"one-device {[h['loss'] for h in runs['one device'][0]]}; "
              f"params bit-equal {equal} (max |d| {worst:.3e})")
        check(runs["dp world 1"][0] == runs["one device"][0] and equal,
              "the world-1 sharded epochs differ from the one-device ones")
        params = trained_params_of(runs["dp world 1"][2])
        n_params = sum(p.numel() for p in params)
        size_mb = n_params * 4 / 1e6

        # host time a step, interleaved, and the all-reduce's device time
        epoch_runners = {
            name: make_epoch_runner(runs[name][3], BATCH,
                                    mesh=None if name == "one device"
                                    else mesh)
            for name in runs}
        interleaved_ms({name: (lambda k, r=r: r(
            x, y, torch.Generator(device=dev).manual_seed(400 + k)))
            for name, r in epoch_runners.items()}, steps, card)
        allreduce_window(f"flagship ({n_params:,} parameters)", params,
                         mesh, size_mb)

        # the sharded online trainer against the one-device one, 2
        # epoch-equivalents, its render launches counted
        online_steps = train_split_size(N_SAMPLES) // BATCH
        got = {}
        for name, m in (("one device", None), ("dp world 1", mesh)):
            model, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
            if m is not None:
                replicate(m, model)
            run = make_online_run_from_loss(
                make_supervised_loss_fn(model, BETA, LAM),
                make_optimizer(model, LR),
                pendulum_batch_fn(BATCH, 64, device=dev), online_steps,
                seed=1, device=dev, mesh=m,
                local_bs=BATCH if m is not None else 0)
            renderer_cuda.launches = 0
            hist = []
            for e in range(2):
                avg = Averager(m)
                avg.add(run(e * online_steps))
                hist.append(avg.result())
            torch.cuda.synchronize()
            key = "dp online" if m is not None else "dp online one-device"
            path_launches[key] = renderer_cuda.launches
            got[name] = (hist, export_params(model))
        equal, worst = same(got["one device"][1], got["dp world 1"][1])
        print(f"dp online, 2 epoch-equivalents of {online_steps} steps: "
              f"losses {[h['loss'] for h in got['dp world 1'][0]]}; params "
              f"bit-equal to the one-device trainer's {equal} (max |d| "
              f"{worst:.3e}); render launches {path_launches['dp online']}")
        check(got["dp world 1"][0] == got["one device"][0] and equal,
              "the world-1 sharded online trainer differs from the "
              "one-device one")
        check(path_launches["dp online"] >= 2 * online_steps,
              "the sharded online trainer launched the render kernel "
              f"{path_launches['dp online']} times")

        # one CelebA epoch at celeba_main's defaults through the sharded
        # trainer with sn_refresh, against the one-device trainer
        config = vars(celeba_args([]))
        cx, cy = (torch.as_tensor(a, device=dev) for a in synthetic_celeba(
            64, config["img_size"], seed=config["seed"]))
        torch.backends.cudnn.deterministic = True
        celeba_runs = {}
        for name, m in (("one device", None), ("dp world 1", mesh)):
            model = build_celeba_model(config, device=dev, seed=0)
            if m is not None:
                replicate(m, model)
            step = make_celeba_step(model, make_optimizer(model, CELEBA_LR),
                                    CELEBA_BETA, CELEBA_LAM, mesh=m)
            hist = run_epochs(step, cx, cy, seed=1, epochs=1,
                              batch_size=CELEBA_BATCH, mesh=m,
                              post_update=lambda model=model:
                              sn_refresh(model))
            celeba_runs[name] = (hist, export_params(model), model)
        torch.backends.cudnn.deterministic = False
        equal, worst = same(celeba_runs["one device"][1],
                            celeba_runs["dp world 1"][1])
        hist = celeba_runs["dp world 1"][0]
        print(f"dp CelebA at the defaults, one epoch of {CELEBA_STEPS} "
              f"steps with sn_refresh: loss {hist[0]['loss']:.4f}; params "
              f"bit-equal to the one-device trainer's {equal} (max |d| "
              f"{worst:.3e}; cuDNN deterministic) [{card}]")
        check(all(math.isfinite(v) for v in hist[0].values()),
              f"CelebA sharded epoch metrics {hist[0]}")
        check(hist == celeba_runs["one device"][0] and equal,
              "the world-1 sharded CelebA epoch differs from the one-device "
              "one")
        cparams = trained_params_of(celeba_runs["dp world 1"][2])
        c_n = sum(p.numel() for p in cparams)
        allreduce_window(f"CelebA ({c_n:,} parameters)", cparams, mesh,
                         c_n * 4 / 1e6)
        del celeba_runs, cparams, cx, cy
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI: --dp 1 and, on one card, --dp 0 run on one device in this
    # process (their render launches counted here); --dp 2 is refused
    renderer_cuda.launches = 0
    for args in (["--dp", "1"], ["--dp", "0"], ["--dp", "1", "--online"]):
        run_dir = work / f"dp_cli_{'_'.join(a.strip('-') for a in args)}"
        said, _, wall = run_cli(["--n_samples", "1000", "--epochs", "1",
                                 "--assets_dir", str(run_dir), *args])
        check("[dp] training" not in said and "[epoch 001]" in said
              and (run_dir / "model_CDGVAE_linear" / "state.pkl").is_file(),
              f"cli.main {' '.join(args)} did not train on one device")
        print(f"cli.main {' '.join(args)}: one device, 1 epoch in "
              f"{wall:.3f} s (host clock) [{card}]")
    path_launches["dp cli"] = renderer_cuda.launches
    check(path_launches["dp cli"] > 0, "the --dp CLI runs rendered nothing")
    try:
        run_cli(["--n_samples", "1000", "--epochs", "1", "--dp", "2",
                 "--assets_dir", str(work / "dp_cli_2")])
        refused = ""
    except SystemExit as e:
        refused = str(e.code)
    print(f"cli.main --dp 2 on {torch.cuda.device_count()} card: {refused}")
    check("2-device mesh" in refused and not (work / "dp_cli_2"
                                              ).exists(),
          "cli.main --dp 2 was not refused by the device count")

    # mesh serving of phase 8's checkpoint against plain serving
    plain = LoadedModel.load(str(ckpt), device=dev)
    meshed = LoadedModel.load(str(ckpt), mesh=make_mesh(1, "cuda"))
    xs = dataset.x_data[:BATCH].cpu().numpy()
    eps = np.random.default_rng(3).standard_normal((BATCH, 4)).astype(
        np.float32)
    worst = 0.0
    for call in (lambda m: m.encode(xs), lambda m: m.reconstruct(xs),
                 lambda m: m.counterfactual(xs, 2, 0.5),
                 lambda m: m.generate(eps)):
        worst = max(worst, float(np.abs(call(meshed) - call(plain)).max()))
    print(f"mesh serving (make_mesh(1, 'cuda')) against plain serving: max "
          f"|d| {worst}")
    check(worst == 0.0, "mesh serving differs from plain serving")

    # the multi-rank dry run on every card of this machine
    renderer_cuda.launches = 0
    dryrun_multichip(torch.cuda.device_count(), "cuda")
    torch.cuda.synchronize()
    path_launches["dp dryrun"] = renderer_cuda.launches
    launches = sum(v for k, v in path_launches.items()
                   if k.startswith("dp "))
    print(f"phase 19 (data parallel, NCCL world 1): "
          f"{time.perf_counter() - t0:.1f} s (host clock); launches "
          f"{{'render': {launches}}} [{card}]")


def packing_and_preprocess(*, root: Path, work: Path, card: str, dev,
                           path_launches: dict) -> None:
    """Phase 20: the packed parameter layout at cli.celeba_main's defaults
    and CelebAMask-HQ preprocessing on the card (see the module
    docstring)."""
    import hashlib

    from torch.profiler import ProfilerActivity, profile

    from cdgvae_torch.cli.celeba_main import get_args
    from cdgvae_torch.data.celeba import synthetic_celeba
    from cdgvae_torch.data.jpeg import read_jpeg_file
    from cdgvae_torch.factory import build_celeba_model
    from cdgvae_torch.models.sagan import sn_refresh
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.ops.packing import Packer
    from cdgvae_torch.train.celeba_steps import make_celeba_step
    from cdgvae_torch.train.scanned import epoch_batches
    from cdgvae_torch.train.steps import make_optimizer
    from cdgvae_torch.utils.interop import export_opt_state, export_params

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    t0 = time.perf_counter()
    renderer_cuda.launches = 0
    config = vars(get_args([]))  # the defaults, --packed_params true
    check(config["packed_params"] is True,
          "celeba_main's --packed_params is not true by default")
    x_np, y_np = synthetic_celeba(64, config["img_size"], seed=config["seed"])
    x_all, y_all = (torch.as_tensor(a, device=dev) for a in (x_np, y_np))

    # 3 steps of each layout from one init and one draw stream, cuDNN
    # deterministic: params, Adam moments and metrics bit for bit
    steppers = {}
    for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        torch.backends.cudnn.deterministic = True
        after = {}
        for layout in ("packed", "unpacked"):
            m = build_celeba_model(config, device=dev, seed=0)
            packer = Packer(m) if layout == "packed" else None
            opt = make_optimizer(m, CELEBA_LR, packer=packer)
            step = make_celeba_step(m, opt, CELEBA_BETA, CELEBA_LAM,
                                    compute_dtype=dtype)
            gen = torch.Generator(device=dev).manual_seed(5)
            hist = []
            for idx in epoch_batches(64, CELEBA_BATCH, gen)[:3]:
                out = step(x_all[idx], y_all[idx], generator=gen)
                sn_refresh(m)
                hist.append({k: v.item() for k, v in out.items()})
            adam = export_opt_state(opt, m)[0]
            after[layout] = (hist, dict(flat(export_params(m))),
                             dict(flat({"mu": adam.mu, "nu": adam.nu})))
            steppers[f"{dname} {layout}"] = (m, step)
            if packer is not None:
                tensors = (f"{packer.n_small} small leaves in "
                           f"{len(packer.flats)} buffer of "
                           f"{sum(f.numel() for f in packer.flats.values()):,}"
                           f" elements, {packer.n_big} big: "
                           f"{len(opt.param_groups[0]['params'])} tensors")
            else:
                tensors = f"{len(opt.param_groups[0]['params'])} tensors"
            print(f"CelebA {dname} {layout}: Adam steps {tensors}")
        torch.backends.cudnn.deterministic = False
        a, b = after["packed"], after["unpacked"]
        equal = a[0] == b[0] and all(
            a[k].keys() == b[k].keys()
            and all(np.array_equal(a[k][n], b[k][n]) for n in a[k])
            for k in (1, 2))
        worst = max(float(np.abs(a[1][n].astype(np.float64)
                                 - b[1][n].astype(np.float64)).max())
                    for n in a[1])
        print(f"CelebA {dname}, 3 steps at the defaults (cuDNN "
              f"deterministic): packed losses "
              f"{[round(h['loss'], 4) for h in a[0]]}; params, Adam "
              f"moments and metrics bit-equal to unpacked {equal} (params "
              f"max |d| {worst:.3e}) [{card}]")
        check(equal and all(math.isfinite(h["loss"]) for h in a[0]),
              f"CelebA {dname}: packed steps differ from unpacked")
    print(f"phase 20, the bit-for-bit steps (4 models built): "
          f"{time.perf_counter() - t0:.1f} s (host clock)")

    # host ms a step over whole epochs, the four paths interleaved, then
    # 2 profiled steps each (warm from the epochs): kernels a step, busy
    # share, cudaLaunchKernel
    def epoch_of(name, k):
        m, step = steppers[name]
        gen = torch.Generator(device=dev).manual_seed(1000 + k)
        for idx in epoch_batches(64, CELEBA_BATCH, gen):
            step(x_all[idx], y_all[idx], generator=gen)
            sn_refresh(m)
        torch.cuda.synchronize()

    host = interleaved_ms({f"CelebA {name}": (lambda k, name=name:
                                              epoch_of(name, k))
                           for name in steppers}, CELEBA_STEPS, card)
    summary = {}
    for name, (m, step) in steppers.items():
        gen = torch.Generator(device=dev).manual_seed(77)
        order = epoch_batches(64, CELEBA_BATCH, gen)[:2]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in order:
                step(x_all[i], y_all[i], generator=gen)
                sn_refresh(m)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        waits = host_waits(events)
        check(not waits, f"CelebA {name} waits for the device or copies: "
              f"{waits}")
        launch_ms = sum(e.self_cpu_time_total for e in events
                        if e.key.startswith("cudaLaunchKernel")) / 1e3 / 2
        n_kernels = sum(e.count for e in kernels) / 2
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
        step_ms = host[f"CelebA {name}"] * 1e3
        summary[name] = (step_ms, n_kernels, busy, launch_ms)
        print(f"CelebA {name}: host {step_ms:.3f} ms a step; profiled 2 "
              f"steps: {n_kernels:.0f} kernels a step, device busy "
              f"{busy:.3f} ms a step, busy share "
              + (f"{busy / step_ms:.3f}" if busy > 0 else "not measured")
              + f", cudaLaunchKernel {launch_ms:.3f} ms a step [{card}]")
    for dname in ("f32", "bf16"):
        p, u = summary[f"{dname} packed"], summary[f"{dname} unpacked"]
        print(f"CelebA {dname} packed against unpacked: host ms a step "
              f"{p[0]:.3f} / {u[0]:.3f}, kernels a step {p[1]:.0f} / "
              f"{u[1]:.0f}, busy ms {p[2]:.3f} / {u[2]:.3f}, "
              f"cudaLaunchKernel ms {p[3]:.3f} / {u[3]:.3f} [{card}]")
    print(f"phase 20, through the timed and profiled steps: "
          f"{time.perf_counter() - t0:.1f} s (host clock)")
    del steppers, x_all, y_all
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    path_launches["packing"] = renderer_cuda.launches
    check(path_launches["packing"] == 0, "the packed CelebA path launched "
          f"the render kernel {path_launches['packing']} times")

    # preprocessing of the fixture corpus: the module entry point in its
    # own process once, then in this one; every file's hash against the
    # JAX package's (expected.json)
    fixtures = root / "tests" / "torch_fixtures" / "celeba_hq"
    corpus = fixtures / "corpus"
    want = json.loads((fixtures / "expected.json").read_text())
    pre = work / "preprocess"
    renderer_cuda.launches = 0
    t_pre = time.perf_counter()
    args = ["--base_dir", str(corpus), "--img_size", "128"]
    proc = subprocess.run(
        [sys.executable, "-m", "cdgvae_torch.cli.celeba_preprocess", *args,
         "--out_dir", str(pre / "128" / "smile")], cwd=root,
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "preprocessed" in proc.stdout,
          f"python -m cdgvae_torch.cli.celeba_preprocess: {proc.returncode} "
          f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
    print(f"python -m cdgvae_torch.cli.celeba_preprocess (its own "
          f"process, on the card): {proc.stdout.strip()} "
          f"({time.perf_counter() - t_pre:.1f} s with the start) [{card}]")
    for size in (128, 64):
        for structure in ("smile", "attractive"):
            for split in ([], ["--test"]):
                if size == 128 and structure == "smile" and not split:
                    continue  # the run above
                run_cli(["--base_dir", str(corpus), "--img_size", str(size),
                         "--causal_structure", structure, "--out_dir",
                         str(pre / str(size) / structure), *split],
                        "celeba_preprocess")
    got = {f"{p.relative_to(pre)}": hashlib.sha256(p.read_bytes()
                                                   ).hexdigest()
           for p in sorted(pre.rglob("*.npy"))}
    same = sum(got.get(k) == v for k, v in want.items())
    print(f"preprocess on the card: {len(got)} .npy files, {same} of "
          f"{len(want)} equal to expected.json (the JAX package's)")
    check(got == want, "preprocess on the card differs from expected.json: "
          f"{sorted(k for k in want if got.get(k) != want[k])[:6]}")

    # files a second at 1024 px: copies of the 1024 px face and its masks
    big = work / "preprocess_1024"
    (big / "CelebA-HQ-img").mkdir(parents=True)
    masks = big / "CelebAMask-HQ-mask-anno" / "0"
    masks.mkdir(parents=True)
    lines = (corpus / "CelebAMask-HQ-attribute-anno.txt").read_text(
        ).splitlines()
    row0 = next(line for line in lines[2:] if line.startswith("0.jpg"))
    # enough copies for 15 s of decoding: 4 in 5 go to the train split
    # (index mod 5 != 4)
    read_jpeg_file(corpus / "CelebA-HQ-img" / "0.jpg")  # warm
    t_one = time.perf_counter()
    read_jpeg_file(corpus / "CelebA-HQ-img" / "0.jpg")
    n_train = math.ceil(15.0 / (time.perf_counter() - t_one))
    n_copies = n_train + -(-n_train // 4)
    rows = []
    for i in range(n_copies):
        shutil.copy(corpus / "CelebA-HQ-img" / "0.jpg",
                    big / "CelebA-HQ-img" / f"{i}.jpg")
        for part in (corpus / "CelebAMask-HQ-mask-anno" / "0").glob(
                "00000_*.png"):
            shutil.copy(part, masks / part.name.replace("00000",
                                                        f"{i:05d}"))
        rows.append(row0.replace("0.jpg", f"{i}.jpg", 1))
    (big / "CelebAMask-HQ-attribute-anno.txt").write_text(
        "\n".join([str(n_copies), lines[1], *rows]) + "\n")
    said, s, wall = run_cli(["--base_dir", str(big), "--out_dir",
                             str(work / "preprocess_1024_out")],
                            "celeba_preprocess")
    n = s["files"]
    print(f"preprocess at 1024 -> 128 px, {n} files (one 4:2:0 q95 face, "
          f"{(corpus / 'CelebA-HQ-img' / '0.jpg').stat().st_size:,} bytes, "
          f"and its masks): {n / wall:.3f} files/s over {wall:.3f} s; host "
          f"decode (JPEG entropy decoding, PNG inflate) "
          f"{s['host'] / n * 1e3:.1f} ms a file, device (IDCT, upsampling, "
          f"colour, resizes, to the host) {s['device'] / n * 1e3:.1f} ms, "
          f"writes {s['write'] / n * 1e3:.1f} ms; 30,000 files would take "
          f"{30000 / (n / wall) / 3600:.2f} h [{card}]")
    check(s["host"] + s["device"] >= 10.0, f"the 1024 px run did only "
          f"{s['host'] + s['device']:.1f} s of work")
    torch.cuda.synchronize()
    path_launches["preprocess"] = renderer_cuda.launches
    check(path_launches["preprocess"] == 0, "preprocessing launched the "
          f"render kernel {path_launches['preprocess']} times")
    print(f"phase 20 (packing, preprocessing): {time.perf_counter() - t0:.1f}"
          f" s (host clock); launches {{'render': 0}} on both [{card}]")


def library_options(*, card: str, dev, dataset, path_launches: dict,
                    profiled_steps) -> None:
    """Phase 21: the library options that no CLI sets, and the CDM study
    cut (see the module docstring)."""
    from cdgvae_torch.factory import build_pendulum_model
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.tools.cdm_seeds import CONFIG as STUDY
    from cdgvae_torch.tools.cdm_seeds import PROTECTED, run_seed
    from cdgvae_torch.train.loop import run_epochs
    from cdgvae_torch.train.online import make_online_scanned_steps
    from cdgvae_torch.train.scanned import (epoch_batches,
                                            make_epoch_runner,
                                            quantize_images, unflatten_items)
    from cdgvae_torch.train.steps import make_optimizer, make_train_step

    t0 = time.perf_counter()
    x, y = dataset.x_data, dataset.y_data
    n, steps = len(x), len(x) // BATCH
    dtypes = {"f32": None, "bf16": torch.bfloat16}

    # (a) 10 bf16 steps against 10 f32 steps from one init and one draw
    # stream: finite falling losses, params and Adam state float32
    models = {}
    order = epoch_batches(n, BATCH,
                          torch.Generator(device=dev).manual_seed(21))[:10]
    for name, dtype in dtypes.items():
        m, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
        opt = make_optimizer(m, LR)
        step = make_train_step(m, opt, BETA, LAM, compute_dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(22)
        losses = [step(x[i], y[i], generator=gen)["loss"].item()
                  for i in order]
        check(all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0],
              f"{name} steps: losses not finite and falling: {losses}")
        kept = {str(t.dtype) for t in (*m.parameters(), *(
            v for st in opt.state.values() for v in st.values()
            if torch.is_tensor(v) and v.is_floating_point() and v.dim()))}
        check(kept == {"torch.float32"}, f"{name}: params and Adam state "
              f"hold {kept}")
        models[name] = (m, opt, step)
        print(f"flagship {name} (compute_dtype {dtype}), 10 steps from one "
              f"init: losses {[round(v, 2) for v in losses]}; params and "
              f"Adam state {sorted(kept)}")

    # one bf16 step on the card against the same step on the CPU: same
    # weights, batch and bf16 noise; the metrics and the gradients
    noise = torch.randn((BATCH, FLAGSHIP["node"]),
                        generator=torch.Generator().manual_seed(23)).to(
                            torch.bfloat16)
    got = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        m, _ = build_pendulum_model(FLAGSHIP, device=d, seed=0)
        opt = make_optimizer(m, LR)
        grads = {}
        opt.register_step_pre_hook(lambda *_, m=m, grads=grads: grads.update(
            {k: p.grad.cpu() for k, p in m.named_parameters()}))
        metrics = make_train_step(m, opt, BETA, LAM,
                                  compute_dtype=torch.bfloat16)(
            x[:BATCH].to(d), y[:BATCH].to(d), noise=noise.to(d))
        got[name] = ({k: v.float().item() for k, v in metrics.items()},
                     grads)
    (m_gpu, g_gpu), (m_cpu, g_cpu) = got["card"], got["cpu"]
    rel = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
              for k in m_cpu)
    frac = max(float((g_gpu[k] - g_cpu[k]).abs().max()
                     / g_cpu[k].abs().max().clamp_min(1e-30))
               for k in g_cpu)
    print(f"bf16 step, card against the CPU (full width, batch {BATCH}): "
          f"metrics max rel {rel:.3e} (loss {m_gpu['loss']:.4f} / "
          f"{m_cpu['loss']:.4f}), gradients max |d| / max |g| {frac:.3e}; "
          f"limits {BF16_METRIC_RTOL:g} and {BF16_GRAD_FRACTION:g}")
    check(rel <= BF16_METRIC_RTOL and frac <= BF16_GRAD_FRACTION,
          "the bf16 step on the card disagrees with the CPU")

    # host ms a step, bf16 against f32, on the dataset path and the online
    # path (whole epochs of 29 steps, interleaved), then 10 and 29
    # profiled steps: device busy a step
    renderer_cuda.launches = 0
    online = {name: make_online_scanned_steps(
        m, opt, BETA, LAM, BATCH, steps, seed=21, device=dev,
        compute_dtype=dtypes[name]) for name, (m, opt, _) in models.items()}

    def dataset_epoch(name, k):
        make_epoch_runner(models[name][2], BATCH)(
            x, y, torch.Generator(device=dev).manual_seed(300 + k))
        torch.cuda.synchronize()

    def online_epoch(name, k):
        online[name](k * steps)
        torch.cuda.synchronize()

    paths = {}
    for name in dtypes:
        paths[f"dataset {name}"] = lambda k, name=name: dataset_epoch(name, k)
        paths[f"online {name}"] = lambda k, name=name: online_epoch(name, k)
    host = interleaved_ms(paths, steps, card)
    busy = {}
    for name in dtypes:
        step = models[name][2]
        gen = torch.Generator(device=dev).manual_seed(24)
        kernels = profiled_steps(
            f"flagship dataset step {name}",
            lambda: [step(x[i], y[i], generator=gen) for i in order], 10,
            host[f"dataset {name}"])
        busy[f"dataset {name}"] = sum(
            e.self_device_time_total for e in kernels) / 1e3 / 10
        kernels = profiled_steps(
            f"flagship online step {name}",
            lambda: online_epoch(name, 50), steps, host[f"online {name}"])
        busy[f"online {name}"] = sum(
            e.self_device_time_total for e in kernels) / 1e3 / steps
    torch.cuda.synchronize()
    path_launches["library online"] = renderer_cuda.launches
    check(path_launches["library online"] > 0,
          "the online bf16 and f32 paths never launched the render kernel")
    for where in ("dataset", "online"):
        b, f = f"{where} bf16", f"{where} f32"
        print(f"flagship {where} step, bf16 / f32: host "
              f"{host[b] * 1e3:.3f} / {host[f] * 1e3:.3f} ms a step, device "
              f"busy {busy[b]:.3f} / {busy[f]:.3f} ms a step [{card}]")

    # (b) uint8 storage of the phase-4 dataset: one epoch on it against
    # one on its dequantised float32 copy, from one init, bit for bit
    u8 = quantize_images(x)
    deq = unflatten_items(u8.reshape(n, -1), x.shape[1:])
    runs = {}
    for name, data in (("uint8", u8), ("float32", deq)):
        m, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
        step = make_train_step(m, make_optimizer(m, LR), BETA, LAM)
        hist = run_epochs(step, data, y, seed=1, epochs=1, batch_size=BATCH)
        runs[name] = (hist, [p.detach().clone() for p in m.parameters()],
                      step, data)
    a, b = runs["uint8"], runs["float32"]
    same = a[0] == b[0] and all(torch.equal(p, q)
                                for p, q in zip(a[1], b[1]))
    print(f"uint8 storage, one epoch of {steps} steps against the "
          f"dequantised float32 copy: loss {a[0][0]['loss']:.4f} / "
          f"{b[0][0]['loss']:.4f}, params bit-equal {same}")
    check(same, "uint8 storage trains another trajectory than its "
          "dequantised float32 copy")

    def storage_epoch(name, k):
        _, _, step, data = runs[name]
        make_epoch_runner(step, BATCH)(
            data, y, torch.Generator(device=dev).manual_seed(400 + k))
        torch.cuda.synchronize()

    host = interleaved_ms({f"storage {name}": (lambda k, name=name:
                                               storage_epoch(name, k))
                           for name in runs}, steps, card)
    print(f"dataset on the device, {n} images: uint8 "
          f"{u8.numel() * u8.element_size():,} bytes, float32 "
          f"{deq.numel() * deq.element_size():,} bytes; host "
          f"{host['storage uint8'] * 1e3:.3f} / "
          f"{host['storage float32'] * 1e3:.3f} ms a step, uint8 / float32 "
          f"[{card}]")
    del models, online, runs, u8, deq

    # (c) the CDM study cut: one seed, 2 epochs, the classifier 1 epoch,
    # on the cut DGP; the protected cells exactly 0.0
    renderer_cuda.launches = 0
    result = run_seed(1, dict(STUDY, epochs=2, classifier_epochs=1,
                              n_samples=N_SAMPLES), device=dev)
    torch.cuda.synchronize()
    path_launches["study"] = renderer_cuda.launches
    upper, lower = result["upper"], result["lower"]
    zeros = [float(m[i][j]) for m in (upper, lower) for i, j in PROTECTED]
    print(f"tools.cdm_seeds.run_seed cut (seed 1, 2 epochs, classifier 1 "
          f"epoch, {N_SAMPLES} samples): losses "
          f"{[round(v, 2) for v in result['loss_curve']]}, upper diagonal "
          f"{np.round(np.diag(upper), 4).tolist()}, protected cells "
          f"{zeros}; train {result['train_seconds']:.2f} s, CDM "
          f"{result['cdm_seconds']:.2f} s; launches {{'render': "
          f"{path_launches['study']}}} [{card}]")
    check(all(v == 0.0 for v in zeros) and np.isfinite(upper).all(),
          "the study's protected CDM cells are not exactly 0.0")
    check(path_launches["study"] == 1,
          f"the study rendered {path_launches['study']} times, not once")
    print(f"phase 21 (library options and the study): "
          f"{time.perf_counter() - t0:.1f} s (host clock) [{card}]")


MIB = 1 << 20
STUDY_MEMORY_TOL = 64 * MIB  # the peak's growth over three cut seeds


def same_record(a: dict, b: dict) -> bool:
    """Two results of a study, bit for bit but for the wall times: their
    JSON text, whose floats print exactly."""
    walls = {"train_seconds", "cdm_seconds", "train_s", "train_wall_s"}

    def strip(r):
        if isinstance(r, dict):
            return {k: strip(v) for k, v in r.items() if k not in walls}
        return r

    def text(r):
        return json.dumps(strip(r), sort_keys=True,
                          default=lambda o: np.asarray(o).tolist())
    return text(a) == text(b)


def studies(*, work: Path, card: str, dev, path_launches: dict) -> None:
    """Phase 22: the studies of ``tools/`` cut (see the module
    docstring)."""
    from cdgvae_torch.data.pendulum_dr import PendulumDRDataset
    from cdgvae_torch.data.tabular.datasets import load_tabular
    from cdgvae_torch.eval.tabular_inference import real_cpdag
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.tools import (cdm_seeds, celeba_arms, celeba_study,
                                    dr_sweep, online_seeds, se_seeds,
                                    tabular_seeds)
    from cdgvae_torch.train.online import train_split_size

    t0 = time.perf_counter()
    cut = dict(cdm_seeds.CONFIG, epochs=2, classifier_epochs=2,
               n_samples=STUDY_N)
    steps = train_split_size(STUDY_N) // BATCH
    # a graphed online run launches the kernel at its eager first step and
    # at each replay, none at the capture: as many launches as steps
    online = 1 + (steps * 2 - 1)
    dr_cut = dict(dr_sweep.CONFIG, epochs=2, n_samples=STUDY_N)
    renderer_cuda.launches = 0
    ds_tr, ds_te, ds_align = (
        PendulumDRDataset(train=train, seed=1, n=STUDY_N,
                          downstream=downstream, device=dev)
        for train, downstream in ((True, True), (False, True),
                                  (True, False)))
    path_launches["dr study data"] = renderer_cuda.launches
    train = load_tabular("loan", train=True)
    test = load_tabular("loan", train=False)
    g_real = real_cpdag(train.frame, "loan")
    # path -> (the cut seed's run given the dispatch keywords, render
    # launches graphed, eager); each run renders its own datasets
    runs = {
        "study jax init": (lambda **kw: cdm_seeds.run_seed(
            1, cut, device=dev, init="jax", **kw), 1, 1),
        "study semi": (lambda **kw: cdm_seeds.run_seed(
            1, cut, semi=True, device=dev, **kw), 2, 2),
        "study infomax": (lambda **kw: cdm_seeds.run_seed(
            1, dict(cut, model="InfoMax"), device=dev, **kw), 1, 1),
        "se study": (lambda **kw: se_seeds.run_seed(1, cut, device=dev,
                                                    **kw), 3, 3),
        "online study": (lambda **kw: online_seeds.run_seed(
            1, cut, device=dev, **kw), 1 + online, 1 + 2 * steps),
        "online semi study": (lambda **kw: online_seeds.run_seed(
            1, cut, semi=True, device=dev, **kw), 2 + online,
            2 + 2 * steps),
        "dr study": (lambda **kw: dr_sweep.run_config(
            0.1, 40.0, ds_align.x_data, ds_align.y_data, ds_tr, ds_te,
            dr_cut, seed=1, repeats=1, init="jax", **kw), 0, 0),
        "dr online study": (lambda **kw: dr_sweep.run_config(
            0.1, 40.0, ds_align.x_data, ds_align.y_data, ds_tr, ds_te,
            dr_cut, seed=1, online=True, repeats=1, **kw), online,
            2 * steps),
        "tabular study": (lambda **kw: tabular_seeds.run_seed(
            "loan", 1, 2, train, test, g_real, device=dev, **kw), 0, 0),
        "tabular tvae study": (lambda **kw: tabular_seeds.run_seed_tvae(
            "loan", 1, 1, test, g_real, train, device=dev, **kw), 0, 0),
    }
    # each cut seed graphed (the tools' default on the card) and --eager,
    # both with capturable Adams: equal bit for bit
    results, seconds = {}, []
    for path, (run, expected, expected_eager) in runs.items():
        got = {}
        for name, kw, want in (
                (path, {}, expected),
                (f"{path} eager", dict(eager=True, capturable=True),
                 expected_eager)):
            renderer_cuda.launches = 0
            t1 = time.perf_counter()
            got[name] = run(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            path_launches[name] = renderer_cuda.launches
            train_s = got[name].get("train_seconds",
                                    got[name].get("train_s"))
            if train_s is None:
                train_s = got[name]["row"]["train_s"]
            seconds.append((name, train_s))
            print(f"{name}: {wall:.1f} s, train {train_s:.3f} s; launches "
                  f"{{'render': {path_launches[name]}}} [{card}]")
            check(path_launches[name] == want, f"{name}: "
                  f"{path_launches[name]} render launches, not {want}")
        graphed, eager = got[path], got[f"{path} eager"]
        check(same_record(graphed, eager), f"{path}: the graphed seed is "
              f"not the eager one bit for bit: {graphed} against {eager}")
        results[path] = graphed
    print(f"phase 22, train seconds a cut seed, graphed and eager (both "
          f"capturable) [{card}]: " + ", ".join(
              f"{name} {s:.3f}" for name, s in seconds))
    for path in ("study jax init", "study semi", "online study",
                 "online semi study"):
        upper, lower = results[path]["upper"], results[path]["lower"]
        zeros = [float(m[i][j]) for m in (upper, lower)
                 for i, j in cdm_seeds.PROTECTED]
        print(f"{path}: losses {np.round(results[path]['loss_curve'], 2)}, "
              f"upper diagonal {np.round(np.diag(upper), 4).tolist()}, "
              f"protected cells {zeros}")
        check(np.isfinite(upper).all() and np.isfinite(lower).all()
              and all(math.isfinite(v) for v in results[path]["loss_curve"]),
              f"{path}: non-finite CDM or loss")
        check(all(v == 0.0 for v in zeros),
              f"{path}: the protected CDM cells are not exactly 0.0")
    upper = results["study infomax"]["upper"]
    check(np.isfinite(upper).all(), "study infomax: non-finite CDM")
    se = results["se study"]["record"]
    print(f"se study: {se}")
    check(all(math.isfinite(v) for v in se.values()),
          f"se study: non-finite record {se}")
    for path in ("dr study", "dr online study"):
        record = results[path]
        print(f"{path}: {record}")
        check(all(math.isfinite(v) for v in (
            record["final_loss"], record["avg_accuracy"],
            record["worst_group_accuracy"], *record["bg_corr_per_latent"])),
            f"{path}: non-finite record {record}")

    # three graphed cut seeds in one process: each seed's runners and
    # their graph pools are freed when it returns, so the peak stays
    renderer_cuda.launches = 0
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    peaks = []
    for seed in (1, 2, 3):
        cdm_seeds.run_seed(seed, cut, device=dev)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    path_launches["study three seeds"] = renderer_cuda.launches
    print(f"study, three graphed cut seeds: peak allocated after each "
          f"{[round(p / MIB, 2) for p in peaks]} MiB, now "
          f"{torch.cuda.memory_allocated() / MIB:.2f} MiB [{card}]")
    check(peaks[2] - peaks[0] <= STUDY_MEMORY_TOL, "study: the peak grew "
          f"by {(peaks[2] - peaks[0]) / MIB:.2f} MiB over three seeds")

    for path, flags in (("tabular study main", ["--epochs", "2"]),
                        ("tabular tvae study main",
                         ["--tvae", "--epochs", "1"])):
        renderer_cuda.launches = 0
        t1 = time.perf_counter()
        out = work / f"{path.replace(' ', '_')}.json"
        summary = tabular_seeds.main(["--datasets", "loan", "--seeds", "1",
                                      "--out", str(out), *flags])
        path_launches[path] = renderer_cuda.launches
        loan = summary["loan"]
        print(f"{path}: {time.perf_counter() - t1:.1f} s; summary "
              f"{json.dumps({k: loan[k] for k in ('per_seed', 'efficacy_baseline', 'efficacy_rows')})}"
              f", loss curve {np.round(loan['loss_curves'][0], 3).tolist()}, "
              f"device {summary['device']}, dispatch {summary['dispatch']}; "
              f"launches {{'render': {path_launches[path]}}} [{card}]")
        check(summary["card"] is not None and out.is_file()
              and summary["dispatch"] == "graphed",
              f"{path}: no card record, no summary file or not graphed")
        check(path_launches[path] == 0, f"{path}: the tabular study "
              f"launched the render kernel {path_launches[path]} times")
        (row,) = loan["per_seed"]
        check(all(math.isfinite(v) for v in (
            row["final_loss"], row["efficacy_synthetic"],
            *loan["loss_curves"][0])) and row["shd_sample"] >= 0,
            f"{path}: non-finite summary {row}")
    # the CelebA study, cut: its corpus, training through celeba_main in a
    # subprocess a seed, and the scores; the do-leakage is 0 by construction
    renderer_cuda.launches = 0
    t1 = time.perf_counter()
    out = work / "celeba_study.json"
    cut_flags = ["--n_train", "32", "--n_test", "16", "--img_size", "32"]
    summary = celeba_study.main([
        *cut_flags, "--conv_dim", "8", "--epochs", "2", "--workdir",
        str(work / "celeba_study"), "--out", str(out)])
    path_launches["celeba study"] = renderer_cuda.launches
    print(f"celeba study: {time.perf_counter() - t1:.1f} s; diagonal "
          f"{summary['diag_mean']}, recon L1 "
          f"{[r['test_recon_l1'] for r in summary['per_seed']]}, do-leakage "
          f"{summary['do_leakage_max']}, device {summary['device']}; "
          f"launches {{'render': {path_launches['celeba study']}}} [{card}]")
    check(out.is_file() and summary["card"] is not None
          and (work / "celeba_do.png").is_file(),
          "celeba study: no summary, card record or do-grid")
    check(summary["do_leakage_max"] == 0.0, "celeba study: do(z_j) moved "
          f"pixels outside its masks: {summary['do_leakage_max']}")
    check(all(math.isfinite(v) for r in summary["per_seed"]
              for v in (r["test_recon_l1"], *summary["diag_mean"])),
          f"celeba study: non-finite scores {summary['per_seed']}")
    check(path_launches["celeba study"] == 0, "celeba study: the render "
          f"kernel launched {path_launches['celeba study']} times")
    (study_row,) = summary["per_seed"]
    # the same seed as two arms of one worker: the second starts from the
    # state the first left, and must score as the study's own process;
    # each arm's memory is freed before the next
    renderer_cuda.launches = 0
    t1 = time.perf_counter()
    arms = [{"tag": tag, "seed": 1, "epochs": 2, "conv_dim": 8}
            for tag in ("_a", "_b")]
    out = work / "arms" / "celeba_arms.json"
    summary = celeba_arms.main([
        *cut_flags, "--arms", json.dumps(arms), "--workdir",
        str(work / "celeba_arms"), "--out", str(out)])
    path_launches["celeba arms"] = renderer_cuda.launches
    marks = summary["per_arm"]
    print(f"celeba arms: {time.perf_counter() - t1:.1f} s; markers {marks}; "
          f"device {summary['device']}; launches {{'render': "
          f"{path_launches['celeba arms']}}} [{card}]")
    check(len(marks) == 2 and not any(m["resumed"] for m in marks),
          f"celeba arms: not two fresh arms: {marks}")
    for m in marks:
        print(f"celeba arm {m['tag']}: allocated before "
              f"{m['allocated_before'] / MIB:.2f} MiB, after "
              f"{m['allocated_after'] / MIB:.2f} MiB, wall {m['wall_s']} s, "
              f"startup {m['startup_s']} s [{card}]")
        check(m["allocated_after"] <= m["allocated_before"],
              f"celeba arm {m['tag']}: more allocated after the arm")
    for arm in arms:
        (row,) = json.loads((out.parent / f"celeba_study{arm['tag']}.json")
                            .read_text())["per_seed"]
        check(same_record(row, study_row), f"celeba arm {arm['tag']}: its "
              f"scores {row} are not the study's {study_row}")
    check(path_launches["celeba arms"] == 0, "celeba arms: the render "
          f"kernel launched {path_launches['celeba arms']} times")
    print(f"phase 22 (the studies): {time.perf_counter() - t0:.1f} s (host "
          f"clock) [{card}]")


def graphed_epochs(*, work: Path, card: str, dev, dataset,
                   path_launches: dict) -> None:
    """Phase 23: the CUDA-graph epoch runner against the eager one (see
    the module docstring)."""
    from functools import partial

    from cdgvae_torch.cli.celeba_main import float32_and_repeatable, get_args
    from cdgvae_torch.data.celeba import CelebADataset
    from cdgvae_torch.factory import build_celeba_model, build_pendulum_model
    from cdgvae_torch.models.sagan import sn_refresh
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.ops.packing import Packer
    from cdgvae_torch.train.celeba_steps import make_celeba_step
    from cdgvae_torch.train.loop import run_epochs
    from cdgvae_torch.train.scanned import NoisePlan, make_epoch_runner
    from cdgvae_torch.train.steps import make_optimizer, make_train_step
    from cdgvae_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from cdgvae_torch.utils.interop import (export_opt_state, export_params,
                                            load_jax_opt_state,
                                            load_jax_params)

    t0 = time.perf_counter()
    renderer_cuda.launches = 0
    float32_and_repeatable()  # celeba_main's switches, as phase 18 runs
    config = vars(get_args([]))  # celeba_main's defaults
    faces = CelebADataset(data_dir="", img_size=config["img_size"],
                          seed=config["seed"])
    x_c = torch.as_tensor(faces.x_data, device=dev)
    y_c = torch.as_tensor(faces.y_data, device=dev)

    def flagship():
        m, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
        opt = make_optimizer(m, LR, capturable=True)
        return (m, opt, make_train_step(m, opt, BETA, LAM), None,
                partial(NoisePlan, m))

    base = build_celeba_model(config, device=dev, seed=0)

    def celeba(dtype):
        def make():
            m = copy.deepcopy(base)
            opt = make_optimizer(m, CELEBA_LR, packer=Packer(m),
                                 capturable=True)
            return (m, opt, make_celeba_step(m, opt, CELEBA_BETA, CELEBA_LAM,
                                             compute_dtype=dtype),
                    partial(sn_refresh, m), partial(NoisePlan, m, dtype=dtype))
        return make

    def state(m, opt) -> dict:
        out = {f"param {n}": p for n, p in m.named_parameters()}
        out.update({f"buffer {n}": b for n, b in m.named_buffers()})
        for i, st in enumerate(opt.state.values()):
            out.update({f"adam {i} {k}": v for k, v in st.items()})
        return out

    # (name, make, x, y, batch, the epoch a graphed run resumes at)
    cases = [("flagship f32", flagship, dataset.x_data, dataset.y_data,
              BATCH, None),
             ("CelebA f32 packed", celeba(None), x_c, y_c, CELEBA_BATCH, 2),
             ("CelebA bf16 packed", celeba(torch.bfloat16), x_c, y_c,
              CELEBA_BATCH, 2)]
    for name, make, x, y, bs, resume_at in cases:
        t_case = time.perf_counter()
        n, steps = len(x), len(x) // bs
        m_e, o_e, step_e, post_e, _ = make()
        hist_e = run_epochs(step_e, x, y, seed=1, epochs=EPOCHS,
                            batch_size=bs, post_update=post_e)
        m_g, o_g, step_g, post_g, plan = make()
        t1 = time.perf_counter()
        hist_g = run_epochs(step_g, x, y, seed=1, epochs=resume_at or EPOCHS,
                            batch_size=bs, post_update=post_g,
                            graph_noise=plan)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        if resume_at is not None:  # a checkpoint, read into a new model
            ck_dir = work / f"graphed_{name.replace(' ', '_')}"
            save_checkpoint(str(ck_dir), export_params(m_g),
                            opt_state=export_opt_state(o_g, m_g),
                            step=resume_at, config=config)
            ck = load_checkpoint(str(ck_dir))
            del m_g, o_g, step_g, post_g, plan
            m_g, o_g, step_g, post_g, plan = make()
            load_jax_params(m_g, ck["params"])
            load_jax_opt_state(o_g, m_g, ck["opt_state"])
            hist_g += run_epochs(step_g, x, y, seed=1, epochs=EPOCHS,
                                 batch_size=bs, start_epoch=resume_at,
                                 post_update=post_g, graph_noise=plan)
            check(int(ck["opt_state"][0].count) == resume_at * steps,
                  f"{name}: the checkpoint's Adam count "
                  f"{ck['opt_state'][0].count}")
        torch.cuda.synchronize()
        a, b = state(m_g, o_g), state(m_e, o_e)
        check(a.keys() == b.keys(), f"{name}: the states differ in layout")
        differ = {k: float((a[k].double() - b[k].double()).abs().max())
                  for k in a if not torch.equal(a[k], b[k])}
        kinds = {kind: sum(k.startswith(kind) for k in a)
                 for kind in ("param", "buffer", "adam")}
        print(f"{name}: {EPOCHS} epochs of {steps} steps, graphed"
              f"{f' (resumed at epoch {resume_at})' if resume_at else ''} "
              f"against eager: {len(a) - len(differ)} of {len(a)} tensors "
              f"equal bit for bit ({kinds}); epoch losses graphed "
              f"{[m['loss'] for m in hist_g]}, eager "
              f"{[m['loss'] for m in hist_e]}; graphed epochs before the "
              f"checkpoint (capture included) {first_s:.3f} s [{card}]")
        check(not differ, f"{name}: graphed differs from eager: {differ}")
        check(hist_g == hist_e, f"{name}: the epoch metrics differ")
        check(all(math.isfinite(m["loss"]) for m in hist_g),
              f"{name}: non-finite loss")

        # host ms a step, the two runners interleaved; the device's busy
        # time from the profiler's kernels over an epoch of each; a
        # replay's device time from CUDA events
        per_call = 1  # epochs a timed call
        runners = {"eager": make_epoch_runner(step_e, bs, post_e),
                   "graphed": make_epoch_runner(step_g, bs, post_g,
                                                graph_noise=plan)}

        def epochs_of(which, k):
            for j in range(per_call):
                runners[which](x, y, torch.Generator(device=dev).manual_seed(
                    500 + 10 * k + j))
            torch.cuda.synchronize()

        host = interleaved_ms({f"{name} {w}": partial(epochs_of, w)
                               for w in runners}, per_call * steps, card)
        busy = {}
        for w in runners:
            b_s, wall, table, kernels, waits = profile_window(
                partial(epochs_of, w, 9))
            busy[w] = b_s / (per_call * steps)
            launches = sum(e.count for e in kernels) / (per_call * steps)
            print(f"{name} {w}: profiled {per_call * steps} steps, device "
                  f"busy {busy[w] * 1e3:.3f} ms a step "
                  f"({launches:.0f} kernels a step) of "
                  f"{host[f'{name} {w}'] * 1e3:.3f} ms host = busy share "
                  f"{busy[w] / host[f'{name} {w}']:.3f}; host waits "
                  f"{waits} [{card}]")
        check(busy["graphed"] > 0, f"{name}: the profiler saw no kernel of "
              "the graphed epochs")
        replay_ms = device_ms(runners["graphed"].graphed.replay, reps=5)
        print(f"{name}: a graphed step's replay {replay_ms:.3f} ms on CUDA "
              f"events (staging excluded); host ms a step eager "
              f"{host[f'{name} eager'] * 1e3:.3f}, graphed "
              f"{host[f'{name} graphed'] * 1e3:.3f}; device busy eager "
              f"{busy['eager'] * 1e3:.3f}, graphed "
              f"{busy['graphed'] * 1e3:.3f} ms a step [{card}]")
        del m_e, o_e, step_e, m_g, o_g, step_g, runners
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 23, {name}: {time.perf_counter() - t_case:.1f} s "
              f"(host clock) [{card}]")
    del base
    path_launches["graphed epochs"] = renderer_cuda.launches
    check(path_launches["graphed epochs"] == 0, "the graphed epochs "
          f"launched the render kernel {renderer_cuda.launches} times")
    print(f"phase 23 (graphed epochs): {time.perf_counter() - t0:.1f} s "
          f"(host clock); launches {{'render': 0}} [{card}]")


def graphed_paths(*, work: Path, card: str, dev, dataset,
                  path_launches: dict) -> None:
    """Phase 24: the graphed runners of every trainer beside the flagship
    and CelebA against their eager runners (see the module docstring)."""
    from functools import partial

    from cdgvae_torch.cli.common import apply_resume
    from cdgvae_torch.cli.tabular_main_tvae import TRANSFORMER_RANDOM_STATE
    from cdgvae_torch.data.pendulum_dr import PendulumDRDataset
    from cdgvae_torch.data.tabular.datasets import (load_tabular,
                                                    load_tabular_tvae)
    from cdgvae_torch.factory import (build_pendulum_model,
                                      build_tabular_model, tvae_block_mask)
    from cdgvae_torch.ops import renderer_cuda
    from cdgvae_torch.train.online import (dr_batch_fn,
                                           make_online_run_from_loss,
                                           pendulum_batch_fn)
    from cdgvae_torch.train.scanned import (NoisePlan, make_epoch_runner,
                                            make_scanned_epochs_semi,
                                            make_supervised_loss_fn)
    from cdgvae_torch.train.steps import (make_infomax_loss_fn,
                                          make_infomax_step, make_optimizer,
                                          make_semi_loss_fn, make_semi_step,
                                          make_train_step,
                                          pair_infomax_optimizer)
    from cdgvae_torch.train.tabular_steps import (make_recon_fn,
                                                  make_sigma_clamp,
                                                  make_tabular_infomax_step,
                                                  make_tabular_step,
                                                  make_tvae_step)
    from cdgvae_torch.utils.checkpoint import save_checkpoint
    from cdgvae_torch.utils.interop import export_opt_state, export_params
    from cdgvae_torch.utils.simulation import EPOCH, derived_generator

    t0 = time.perf_counter()
    renderer_cuda.launches = 0
    dr_ds = PendulumDRDataset(n=N_SAMPLES, device=dev)  # one launch
    n_l = int(len(dataset) * 0.1)  # main_semi's labeled 10%
    pend = (dataset.x_data, dataset.y_data)
    dr = (dr_ds.x_data, dr_ds.y_data)
    loan = load_tabular("loan")
    tab = (torch.as_tensor(loan.x_data, device=dev),
           torch.as_tensor(loan.label, device=dev))
    recon = make_recon_fn("loan", loan.flatten_topology)
    tv = load_tabular_tvae("loan",
                           random_state=TRANSFORMER_RANDOM_STATE["loan"])
    oil = tv.transformer.output_info_list
    tvd = (torch.as_tensor(tv.x_data, device=dev),
           torch.as_tensor(tv.label, device=dev))
    tv_cfg = {"model": "TVAE", "dataset": "loan", "scm": "linear",
              "input_dim": tv.transformer.output_dimensions,
              "tvae_mask": tvae_block_mask("loan", oil)}
    dr_cfg = dict(FLAGSHIP, node=5)
    semi_cfg = dict(FLAGSHIP, model="CDGVAEsemi", scm="nonlinear")
    im_cfg = dict(FLAGSHIP, model="InfoMax")

    def pendulum(cfg, spurious=False):
        m, d = build_pendulum_model(cfg, spurious=spurious, device=dev,
                                    seed=0)
        pairs = [(m, make_optimizer(m, LR, capturable=True))]
        if d is not None:
            pairs.append((d, make_optimizer(d, LR_D, capturable=True)))
        return pairs

    def tabular(name):
        m, d = build_tabular_model({"model": name, "dataset": "loan",
                                    "scm": "linear"}, device=dev, seed=0)
        pairs = [(m, make_optimizer(m, TAB_LR, capturable=True))]
        if d is not None:  # tabular_main's --lr_D
            pairs.append((d, make_optimizer(d, 1e-3, capturable=True)))
        return pairs

    def tvae_pairs():
        m, _ = build_tabular_model(dict(tv_cfg), device=dev, seed=0)
        return [(m, make_optimizer(m, TVAE_LR, capturable=True,
                                   weight_decay=TVAE_WD))]

    def plan(pairs, marginal=None):
        return partial(NoisePlan, pairs[0][0], marginal=marginal)

    def pair_opt(pairs):
        return (pair_infomax_optimizer(pairs[0][1], pairs[1][1])
                if len(pairs) == 2 else pairs[0][1])

    # name: (kind, data, make() -> (pairs, step or loss_fn, plan, post,
    # batch function or None)); every model at full width
    def epoch_case(data, build, step_of, marginal=None, post_of=None):
        def make():
            pairs = build()
            return (pairs, step_of(pairs), plan(pairs, marginal),
                    post_of(pairs) if post_of else None, None)
        return "epoch", data, make

    def semi_case(data, cfg, spurious=False):
        def make():
            pairs = pendulum(cfg, spurious)
            m, o = pairs[0]
            return pairs, make_semi_step(m, o, BETA, LAM), plan(pairs), \
                None, None
        return "semi", (data[0], data[0][:n_l], data[1][:n_l]), make

    def online_case(cfg, loss_of, spurious=False, marginal=None,
                    labeled=False):
        def make():
            pairs = pendulum(cfg, spurious)
            batch = (dr_batch_fn if spurious else pendulum_batch_fn)(
                BATCH, 64, device=dev)
            return (pairs, loss_of(pairs), plan(pairs, marginal), None,
                    batch)
        data = (pend[0][:n_l], pend[1][:n_l]) if labeled else None
        return "online", data, make

    cases = {
        "semi": semi_case(pend, semi_cfg),
        "InfoMax": epoch_case(pend, partial(pendulum, im_cfg), lambda p:
                              make_infomax_step(p[0][0], p[1][0], p[0][1],
                                                p[1][1], BETA, LAM, GAMMA),
                              marginal="permutation"),
        "DR CDG-VAE": epoch_case(dr, partial(pendulum, dr_cfg, True),
                                 lambda p: make_train_step(
                                     p[0][0], p[0][1], BETA, DR_LAM)),
        "DR semi": semi_case(dr, dict(dr_cfg, model="CDGVAEsemi",
                                      scm="nonlinear"), spurious=True),
        "tabular CDG-VAE loan": epoch_case(
            tab, partial(tabular, "CDGVAE"), lambda p: make_tabular_step(
                p[0][0], p[0][1], TAB_BETA, TAB_LAM, recon)),
        "tabular InfoMax loan": epoch_case(
            tab, partial(tabular, "InfoMax"),
            lambda p: make_tabular_infomax_step(
                p[0][0], p[1][0], p[0][1], p[1][1], TAB_BETA, TAB_LAM, GAMMA,
                recon), marginal="permutation"),
        "TVAE loan": epoch_case(
            tvd, tvae_pairs, lambda p: make_tvae_step(p[0][0], p[0][1],
                                                      TVAE_LAM, oil),
            post_of=lambda p: make_sigma_clamp(p[0][0], TVAE_SIGMA)),
        "online": online_case(FLAGSHIP, lambda p: make_supervised_loss_fn(
            p[0][0], BETA, LAM)),
        "online DR": online_case(dr_cfg, lambda p: make_supervised_loss_fn(
            p[0][0], BETA, DR_LAM), spurious=True),
        "online semi": online_case(semi_cfg, lambda p: make_semi_loss_fn(
            p[0][0], BETA, LAM), labeled=True),
        "online InfoMax": online_case(im_cfg, lambda p: make_infomax_loss_fn(
            p[0][0], p[1][0], BETA, LAM, GAMMA), marginal="permutation"),
    }
    online_call = len(dataset) // BATCH  # 29 steps a call, 2 calls
    bs_of = {"tabular CDG-VAE loan": TAB_BATCH,
             "tabular InfoMax loan": TAB_BATCH, "TVAE loan": TAB_BATCH}

    def runner(name, built, graphed):
        kind, data, _ = cases[name]
        pairs, fn, noise, post, batch = built
        noise = noise if graphed else None
        if kind == "semi":
            return make_scanned_epochs_semi(fn, BATCH, BATCH_L,
                                            graph_noise=noise)
        if kind == "epoch":
            return make_epoch_runner(fn, bs_of.get(name, BATCH), post,
                                     graph_noise=noise)
        return make_online_run_from_loss(
            fn, pair_opt(pairs), batch, online_call, seed=1, device=dev,
            labeled=data, batch_size_l=BATCH_L if data else 0,
            graph_noise=noise)

    def call(name, run, k):
        """Epoch (online: call) k of the runner, ending in a host sync."""
        kind, data, _ = cases[name]
        if kind == "online":
            out = run(k * online_call)
            torch.cuda.synchronize()
            return out
        return run(*data, derived_generator(1, EPOCH, k, device=dev))

    def state(pairs) -> dict:
        out = {}
        for j, (m, opt) in enumerate(pairs):
            out.update({f"{j} param {n}": p for n, p in m.named_parameters()})
            out.update({f"{j} buffer {n}": b for n, b in m.named_buffers()})
            for i, st in enumerate(opt.state.values()):
                out.update({f"{j} adam {i} {k}": v for k, v in st.items()})
        return out

    def same(name, a, b, what) -> int:
        check(a.keys() == b.keys(), f"{name}: the states differ in layout")
        differ = {k: float((a[k].double() - b[k].double()).abs().max())
                  for k in a if not torch.equal(a[k], b[k])}
        check(not differ, f"{name}: {what} differs from eager: {differ}")
        return len(a)

    def same_history(name, h_g, h_e):
        if cases[name][0] != "online":
            check(h_g == h_e, f"{name}: the epoch metrics differ")
            return [m["loss"] for m in h_g]
        for g, e in zip(h_g, h_e):
            check(g.keys() == e.keys() and all(torch.equal(g[k], e[k])
                                               for k in g),
                  f"{name}: the per-step metrics differ")
        return [float(m["loss"].mean()) for m in h_g]

    rows = []
    eager_im = None
    for name, (kind, data, make) in cases.items():
        t_case = time.perf_counter()
        calls = 2 if kind == "online" else EPOCHS
        runs = {}
        for w in ("eager", "graphed"):
            built = make()
            run = runner(name, built, w == "graphed")
            before = renderer_cuda.launches
            hist = [call(name, run, k) for k in range(calls)]
            torch.cuda.synchronize()
            renders = renderer_cuda.launches - before
            runs[w] = (built, run, hist)
            if kind == "online":  # one render a step, none for a capture
                check(renders == calls * online_call, f"{name} {w}: "
                      f"{renders} render launches for "
                      f"{calls * online_call} steps")
        n_t = same(name, state(runs["graphed"][0][0]),
                   state(runs["eager"][0][0]), "graphed")
        losses = same_history(name, runs["graphed"][2], runs["eager"][2])
        check(all(math.isfinite(v) for v in losses),
              f"{name}: non-finite loss {losses}")
        steps = online_call if kind == "online" else (
            len(data[0]) // bs_of.get(name, BATCH))
        print(f"{name}: {calls} {'calls' if kind == 'online' else 'epochs'}"
              f" of {steps} steps, graphed against eager: {n_t} tensors "
              f"equal bit for bit, metrics equal; losses {losses} [{card}]")
        if name == "InfoMax":  # the resume below is held to this state
            eager_im = {k: v.clone()
                        for k, v in state(runs["eager"][0][0]).items()}

        # host ms a step, the two runners interleaved; the device's busy
        # time and kernels a step from the profiler over a call of each; a
        # replay's device time from CUDA events
        timed = {w: runs[w][1] for w in runs}
        # (each runner has run its calls: no warm-up round)
        host = interleaved_ms({f"{name} {w}": partial(
            lambda w, k: call(name, timed[w], calls + k), w)
            for w in timed}, steps, card, warm=False)
        busy, kernels = {}, {}
        for w in timed:
            b_s, _, _, kern, _ = profile_window(
                partial(call, name, timed[w], calls + 5), warm=False)
            busy[w] = b_s / steps
            kernels[w] = sum(e.count for e in kern) / steps
        check(busy["graphed"] > 0, f"{name}: the profiler saw no kernel of "
              "the graphed runner")
        replay_ms = device_ms(timed["graphed"].graphed.replay, reps=5)
        rows.append((name, host[f"{name} eager"], host[f"{name} graphed"],
                     busy["eager"], busy["graphed"], replay_ms,
                     kernels["eager"], kernels["graphed"]))
        print(f"phase 24, {name}: host ms a step eager "
              f"{host[f'{name} eager'] * 1e3:.3f} -> graphed "
              f"{host[f'{name} graphed'] * 1e3:.3f} (median of 3 "
              f"interleaved rounds); device busy eager "
              f"{busy['eager'] * 1e3:.3f}, graphed "
              f"{busy['graphed'] * 1e3:.3f} ms a step; a replay "
              f"{replay_ms:.3f} ms on CUDA events; kernels a step eager "
              f"{kernels['eager']:.0f}, graphed {kernels['graphed']:.0f}; "
              f"{time.perf_counter() - t_case:.1f} s (host clock) [{card}]")
        del runs, timed
        gc.collect()
        torch.cuda.empty_cache()

    # the graphed InfoMax run resumed from a checkpoint after epoch 2 (the
    # discriminator and its Adam in the extras, read as --resume reads
    # them) against the uninterrupted eager run above
    kind, data, make = cases["InfoMax"]
    built = make()
    run = runner("InfoMax", built, True)
    for k in range(EPOCHS - 1):
        call("InfoMax", run, k)
    (m, o), (d, od) = built[0]
    ck_dir = work / "graphed_infomax_resume"
    save_checkpoint(str(ck_dir), export_params(m),
                    opt_state=export_opt_state(o, m), step=EPOCHS - 1,
                    config={}, extras={"d_params": export_params(d),
                                       "opt_state_d": export_opt_state(od, d)})
    built = make()
    (m, o), (d, od) = built[0]
    _, start = apply_resume({"resume": str(ck_dir), "epochs": EPOCHS},
                            (m, d, o, od))
    check(start == EPOCHS - 1, f"InfoMax resumed at epoch {start}")
    run = runner("InfoMax", built, True)
    call("InfoMax", run, EPOCHS - 1)
    torch.cuda.synchronize()
    n_t = same("InfoMax resumed", state(built[0]), eager_im,
               "the graphed resume")
    print(f"InfoMax resumed: {EPOCHS - 1} graphed epochs, a checkpoint with "
          f"the discriminator's state, then a graphed epoch from it, "
          f"against {EPOCHS} eager epochs: {n_t} tensors equal bit for bit "
          f"[{card}]")

    print(f"phase 24 summary [{card}]: path | host ms a step eager -> "
          "graphed | busy ms a step eager / graphed | a replay, ms | "
          "kernels a step eager / graphed")
    for name, he, hg, be, bg, rp, ke, kg in rows:
        print(f"  {name} | {he * 1e3:.3f} -> {hg * 1e3:.3f} | "
              f"{be * 1e3:.3f} / {bg * 1e3:.3f} | {rp:.3f} | {ke:.0f} / "
              f"{kg:.0f}")
    path_launches["graphed paths"] = renderer_cuda.launches
    print(f"phase 24 (graphed paths): {time.perf_counter() - t0:.1f} s "
          f"(host clock); launches {{'render': "
          f"{path_launches['graphed paths']}}} [{card}]")


def capturable_adam(*, card: str, dev) -> None:
    """Phase 25: the capturable Adam of every graphed trainer against a
    float64 copy of optax's update (``tools/adam_check.py``)."""
    from cdgvae_torch.tools import adam_check

    t0 = time.perf_counter()
    for case in ("cdgvae 16px", "packed celeba"):
        make_build, wd = adam_check.CASES[case]
        t1 = time.perf_counter()
        result = adam_check.compare(make_build(), dev, weight_decay=wd)
        print(f"{adam_check.format_result(case, result)}; bounds: "
              f"{adam_check.ATOL_ONE:g} after 1 step, "
              f"{adam_check.ATOL_MANY:g} and {adam_check.RATIO:g} x the "
              f"plain Adam's after {adam_check.STEPS} "
              f"({time.perf_counter() - t1:.1f} s) [{card}]")
        missed = adam_check.violations(result)
        check(not missed, f"adam {case}: {missed}")
        check(result["graphed"] == result["capturable"], f"adam {case}: "
              "the graphed update is not the eager one")
    print(f"phase 25 (the capturable Adam): {time.perf_counter() - t0:.1f} "
          f"s (host clock) [{card}]")


def flat_leaves(tree: dict) -> list:
    """The leaves of a nested dict, in key order."""
    return [leaf for k in sorted(tree) for leaf in (
        flat_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def trained_params_of(model) -> list:
    return [p for p in model.parameters() if p.requires_grad]


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
    from cdgvae_torch.cli.main_classifier import classifier_masks
    from cdgvae_torch.data.pendulum import PendulumDataset, sample_factors_real
    from cdgvae_torch.eval.metric import cdm_matrices
    from cdgvae_torch.factory import build_pendulum_model
    from cdgvae_torch.models.classifier import FactorClassifier
    from cdgvae_torch.ops import _build, renderer_cuda
    from cdgvae_torch.ops.renderer import render_reference
    from cdgvae_torch.train.loop import format_epoch, run_epochs
    from cdgvae_torch.train.online import (make_online_run_from_loss,
                                           make_online_scanned_steps,
                                           pendulum_batch_fn,
                                           sample_factors_device,
                                           train_split_size)
    from cdgvae_torch.train.scanned import (Averager, epoch_batches,
                                            labeled_batches,
                                            make_epoch_runner,
                                            make_scanned_epochs_semi,
                                            make_supervised_loss_fn)
    from cdgvae_torch.train.steps import (make_infomax_loss_fn,
                                          make_infomax_step, make_optimizer,
                                          make_semi_loss_fn, make_semi_step,
                                          make_train_step)
    from cdgvae_torch.utils.checkpoint import load_checkpoint
    from cdgvae_torch.utils.interop import load_jax_params
    from cdgvae_torch.utils.simulation import ONLINE_STEP, derived_seed

    import scipy

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, numpy "
          f"{np.__version__}, scipy {scipy.__version__}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
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
    said, _, cli_s = run_cli(["--n_samples", str(N_SAMPLES), "--epochs", "2",
                              "--assets_dir", str(cli_dir)])
    for name in ("state.pkl", "config.json"):
        check((ckpt / name).is_file(), f"the CLI wrote no {name}")
    check((cli_dir / "recon.png").is_file(), "the CLI wrote no recon.png")
    check(f"checkpoint saved to {ckpt}" in said, "no 'checkpoint saved' line")
    check(len(read_records(cli_dir / "metrics.jsonl")) == 2,
          "metrics.jsonl does not hold 2 records")
    said, _, _ = run_cli(["--n_samples", str(N_SAMPLES), "--epochs", "3",
                          "--assets_dir", str(cli_dir), "--resume",
                          str(ckpt)])
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
    _, _, online_cli_s = run_cli(["--online", "--n_samples", str(N_SAMPLES),
                                  "--epochs", "2", "--assets_dir",
                                  str(online_dir)])
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

    def dataset_epoch(k):
        return data_epoch(dataset.x_data, dataset.y_data,
                          torch.Generator(device=dev).manual_seed(100 + k))

    med = interleaved_ms({"dataset": dataset_epoch, "online": online_epoch,
                          "draw and render": draws,
                          "generator reseed": reseeds}, steps, card)

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
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    probe_host("torch.set_num_threads(1)")
    gc.collect()
    gc.freeze()
    probe_host("gc.collect() and gc.freeze()")
    torch.set_num_threads(n_threads)  # phases 12-13 hold the card to the CPU

    def finite_falling(name: str, records: list[dict]) -> list[float]:
        losses = [r["loss"] for r in records]
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"{name}: losses not finite and falling: {losses}")
        return losses

    def profiled_steps(name: str, fn, n: int, step_s: float) -> list:
        """Profile ``fn`` (n steps): busy share against the unprofiled host
        time a step ``step_s``; fail on a host wait or copy. Returns the
        window's kernels, sorted by device time."""
        busy, wall, table, kernels, waits = profile_window(fn)
        if busy > 0:
            print(f"{name}, profiled {n} steps: device busy {busy * 1e3:.3f} "
                  f"ms of {wall * 1e3:.3f} ms wall; per step "
                  f"{busy / n * 1e3:.3f} ms busy of {step_s * 1e3:.3f} ms "
                  f"unprofiled = {busy / n / step_s:.3f} busy share; host "
                  f"waits and copies {waits} [{card}]")
            print(table)
        else:
            print(f"profiler saw no device kernels: {name} busy share not "
                  "measured")
        check(not waits, f"{name} waits for the device or copies to or from "
              f"it: {waits}")
        return kernels

    # 11. semi-supervised training through cli.main_semi: the fixed
    # datasets (labeled 10%, 371 rows), --resume, then --online
    semi_dir = work / "semi"
    semi_ckpt = semi_dir / "model_CDGVAEsemi_nonlinear"
    semi_args = ["--n_samples", str(N_SAMPLES), "--labeled_ratio", "0.1",
                 "--batch_sizeL", str(BATCH_L)]
    renderer_cuda.launches = 0
    _, _, semi_cli_s = run_cli(semi_args + ["--epochs", "2", "--assets_dir",
                                            str(semi_dir)], "main_semi")
    check(renderer_cuda.launches == 2, f"semi: {renderer_cuda.launches} "
          "render launches for the labeled and unlabeled datasets, not 2")
    said, _, _ = run_cli(semi_args + ["--epochs", "3", "--assets_dir",
                                      str(semi_dir), "--resume",
                                      str(semi_ckpt)], "main_semi")
    path_launches["semi"] = renderer_cuda.launches
    check(path_launches["semi"] == 4, f"semi: {path_launches['semi']} render "
          "launches over the two runs, not 4")
    check(f"resumed from {semi_ckpt} at epoch 2" in said, "semi: no "
          "'resumed' line")
    ck = load_checkpoint(str(semi_ckpt))
    check(ck["step"] == 3 and int(ck["opt_state"][0].count) == 3 * steps,
          f"semi checkpoint at step {ck['step']}, Adam count "
          f"{int(ck['opt_state'][0].count)}")
    losses = finite_falling("semi", read_records(semi_dir / "metrics.jsonl"))
    print(f"semi cli: 2 epochs in {semi_cli_s:.3f} s (host clock, both "
          f"datasets and the checkpoint included), resumed to epoch 3, "
          f"losses {losses}; fixed path launches {{'render': "
          f"{path_launches['semi']}}} (2 a run) [{card}]")
    semi_online_dir = work / "semi_online"
    renderer_cuda.launches = 0
    _, _, semi_online_s = run_cli(semi_args + [
        "--online", "--epochs", "2", "--assets_dir", str(semi_online_dir)],
        "main_semi")
    path_launches["semi online"] = renderer_cuda.launches
    check(path_launches["semi online"] >= online_steps + 1,
          f"semi online: {path_launches['semi online']} render launches "
          f"for {online_steps} steps")
    losses = finite_falling("semi online",
                            read_records(semi_online_dir / "metrics.jsonl"))
    print(f"semi online cli: {online_steps} steps in {semi_online_s:.3f} s "
          f"(host clock), losses {losses}; launches {{'render': "
          f"{path_launches['semi online']}}} [{card}]")

    # the semi step timed against the dataset step, both on the linear
    # flagship, so that they differ by the labeled encode alone
    n_l = int(len(dataset) * 0.1)
    x_l, y_l = dataset.x_data[:n_l], dataset.y_data[:n_l]
    semi_model, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
    semi_opt = make_optimizer(semi_model, LR)
    semi_step = make_semi_step(semi_model, semi_opt, BETA, LAM)
    semi_run = make_scanned_epochs_semi(semi_step, BATCH, BATCH_L)
    med = interleaved_ms({"dataset": dataset_epoch, "semi": lambda k: semi_run(
        dataset.x_data, x_l, y_l,
        torch.Generator(device=dev).manual_seed(300 + k))}, steps, card)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = list(zip(epoch_batches(len(dataset), BATCH, gen)[:10],
                       labeled_batches(n_l, 10, BATCH_L, gen)))
    profiled_steps("semi step", lambda: [
        semi_step(dataset.x_data[u], x_l[l], y_l[l], generator=gen)
        for u, l in batches], 10, med["semi"])
    online_semi = make_online_run_from_loss(
        make_semi_loss_fn(semi_model, BETA, LAM), semi_opt, sample, 10,
        seed=1, device=dev, labeled=(x_l, y_l), batch_size_l=BATCH_L)
    profiled_steps("online semi step (labeled subsample drawn on the card)",
                   lambda: online_semi(0), 10, med["semi"])
    probe_host("phase 11")

    # 12. InfoMax through cli.main: 2 epochs, --resume to 3, --eager,
    # --online; the full-width loss on the card against the CPU
    im_dir = work / "infomax"
    im_ckpt = im_dir / "model_InfoMax_linear"
    im_args = ["--model", "InfoMax", "--n_samples", str(N_SAMPLES)]
    renderer_cuda.launches = 0
    _, _, im_cli_s = run_cli(im_args + ["--epochs", "2", "--assets_dir",
                                        str(im_dir)])
    said, _, _ = run_cli(im_args + ["--epochs", "3", "--assets_dir",
                                    str(im_dir), "--resume", str(im_ckpt)])
    check(f"resumed from {im_ckpt} at epoch 2" in said, "InfoMax: no "
          "'resumed' line")
    ck = load_checkpoint(str(im_ckpt))
    extras = ck["extras"] or {}
    check({"d_params", "opt_state_d"} <= set(extras),
          f"InfoMax checkpoint extras {sorted(extras)}")
    counts = (int(ck["opt_state"][0].count),
              int(extras["opt_state_d"][0].count))
    check(ck["step"] == 3 and counts == (3 * steps, 3 * steps),
          f"InfoMax checkpoint at step {ck['step']}, Adam counts {counts}")
    im_eager_dir, im_online_dir = work / "infomax_eager", work / "infomax_on"
    _, _, im_eager_s = run_cli(im_args + ["--eager", "--epochs", "1",
                                          "--assets_dir", str(im_eager_dir)])
    _, _, im_online_s = run_cli(im_args + ["--online", "--epochs", "2",
                                           "--assets_dir", str(im_online_dir)])
    path_launches["infomax"] = renderer_cuda.launches
    check(path_launches["infomax"] >= 3 + online_steps + 1,
          f"InfoMax: {path_launches['infomax']} render launches")
    for d in (im_dir, im_eager_dir, im_online_dir):
        mi = [r["MutualInfo"] for r in read_records(d / "metrics.jsonl")]
        check(len(mi) > 0 and all(math.isfinite(v) for v in mi),
              f"InfoMax MutualInfo {mi} in {d.name}")
        print(f"InfoMax {d.name}: MutualInfo {mi}")
    finite_falling("InfoMax", read_records(im_dir / "metrics.jsonl"))
    finite_falling("InfoMax online", read_records(im_online_dir /
                                                  "metrics.jsonl"))
    print(f"InfoMax cli: 2 epochs in {im_cli_s:.3f} s, --eager 1 epoch in "
          f"{im_eager_s:.3f} s, --online {online_steps} steps in "
          f"{im_online_s:.3f} s (host clock); launches {{'render': "
          f"{path_launches['infomax']}}} [{card}]")
    im_cfg = dict(FLAGSHIP, model="InfoMax")
    perm = torch.as_tensor(rng.permutation(BATCH))
    for d in ("cpu", "cuda"):
        m, disc = build_pendulum_model(im_cfg, device=d, seed=0)
        _, metrics = make_infomax_loss_fn(m, disc, BETA, LAM, GAMMA)(
            batch.to(d), labels.to(d), noise=noise.to(d), perm=perm.to(d))
        result[d] = metrics["loss"].item()
    rel = abs(result["cuda"] - result["cpu"]) / abs(result["cpu"])
    print(f"full-width InfoMax loss cuda {result['cuda']:.6f} cpu "
          f"{result['cpu']:.6f} rel {rel:.2e}")
    check(rel <= 1e-5, "full-width InfoMax loss on the card disagrees with "
          "the CPU")
    im_model, im_disc = build_pendulum_model(im_cfg, device=dev, seed=0)
    im_step = make_infomax_step(im_model, im_disc,
                                make_optimizer(im_model, LR),
                                make_optimizer(im_disc, LR_D), BETA, LAM,
                                GAMMA)
    im_run = make_epoch_runner(im_step, BATCH)
    med = interleaved_ms({"dataset": dataset_epoch, "infomax": lambda k: im_run(
        dataset.x_data, dataset.y_data,
        torch.Generator(device=dev).manual_seed(400 + k))}, steps, card)
    profiled_steps("InfoMax step", lambda: [
        im_step(dataset.x_data[i], dataset.y_data[i], generator=generator)
        for i in order], len(order), med["infomax"])
    probe_host("phase 12")

    # 13. eval: the CDM classifier, the metric on phase 8's and phase 11's
    # checkpoints (exact structural zeros), cdm_matrices on the card against
    # the CPU, the inference diagnostics
    clf_dir, cdm_dir, inf_dir = work / "clf", work / "cdm", work / "inference"
    renderer_cuda.launches = 0
    _, _, clf_s = run_cli(["--n_samples", str(N_SAMPLES), "--epochs", "2",
                           "--assets_dir", str(clf_dir)], "main_classifier")
    clf_ckpt = clf_dir / "CDMClassifier"
    finite_falling("classifier", read_records(clf_dir / "metrics.jsonl"))
    metric_s = {}
    for name, ck_dir, tag in (("CDG-VAE, phase 8", ckpt, "CDGVAE_linear_0"),
                              ("semi, phase 11", semi_ckpt,
                               "CDGVAEsemi_nonlinear_0")):
        _, (lower, upper), metric_s[name] = run_cli(
            ["--checkpoint", str(ck_dir), "--classifier_checkpoint",
             str(clf_ckpt), "--assets_dir", str(cdm_dir)], "metric")
        for which, mat in (("lower", lower), ("upper", upper)):
            text = read_csv_matrix(cdm_dir / f"{which}_{tag}.csv")
            for s, c in STRUCTURAL_ZEROS:
                check(mat[s, c] == 0.0 and text[s + 1][c + 1] == "0.0",
                      f"CDM {which} ({name}) [{s}, {c}] = {mat[s, c]!r}, "
                      f"csv {text[s + 1][c + 1]}")
        check(upper[0, 0] > 0 and upper[1, 1] > 0,
              f"CDM ({name}): an intervened factor moves no score")
        print(f"CDM ({name}): the {len(STRUCTURAL_ZEROS)} structural zeros "
              f"read exactly 0.0 in lower and upper")
    clf_params = load_checkpoint(str(clf_ckpt))["params"]
    cdm = {}
    for d in ("cpu", "cuda"):
        clf = FactorClassifier(classifier_masks(64, 4), 4, 64, device=d)
        load_jax_params(clf, clf_params)
        cdm[d] = cdm_matrices(LoadedModel.load(str(semi_ckpt), device=d).model,
                              clf, dataset.x_data[:512].to(d))
    cdm_err = max(float(np.abs(cdm["cuda"][i] - cdm["cpu"][i]).max())
                  for i in (0, 1))
    print(f"cdm_matrices on 512 images, cuda against cpu: max |d| "
          f"{cdm_err:.3e} (limit {CDM_TOL})")
    check(cdm_err <= CDM_TOL, "cdm_matrices on the card disagrees with the "
          "CPU")
    _, grid, inf_s = run_cli(["--checkpoint", str(semi_ckpt), "--assets_dir",
                              str(inf_dir)], "inference")
    check(grid.shape == (4, 7, 64, 64, 3) and np.isfinite(grid).all(),
          f"do grid {grid.shape}")
    for png in INFERENCE_PNGS:
        check((inf_dir / png).is_file(), f"inference wrote no {png}")
    path_launches["eval"] = renderer_cuda.launches
    check(path_launches["eval"] == 4, f"eval: {path_launches['eval']} render "
          "launches, not 4 (classifier 1, metric 2, inference 1)")
    print(f"eval cli wall (host clock, dataset builds included): "
          f"main_classifier 2 epochs {clf_s:.3f} s; metric "
          + "; ".join(f"{k} {v:.3f} s" for k, v in metric_s.items())
          + f"; inference {inf_s:.3f} s; launches {{'render': "
          f"{path_launches['eval']}}} [{card}]")
    probe_host("phase 13")

    # 14. DR and downstream
    max_err = max(max_err, dr_and_downstream(
        work=work, card=card, dev=dev, rng=rng, steps=steps,
        online_steps=online_steps, path_launches=path_launches,
        pendulum_ckpt=ckpt, pendulum_rows=rows, dataset_epoch=dataset_epoch,
        check_render=check_render, finite_falling=finite_falling,
        profiled_steps=profiled_steps))

    # 15. PNG trees
    max_err = max(max_err, png_trees(
        work=work, card=card, dev=dev, path_launches=path_launches,
        clf_ckpt=clf_ckpt, check_render=check_render,
        finite_falling=finite_falling))

    # 16. the tabular family
    tabular(work=work, card=card, dev=dev, rng=rng,
            profiled_steps=profiled_steps)

    # 17. the CDG-TVAE, which renders nothing
    renderer_cuda.launches = 0
    t0 = time.perf_counter()
    tvae(work=work, card=card, dev=dev, rng=rng,
         profiled_steps=profiled_steps)
    path_launches["tvae"] = renderer_cuda.launches
    check(path_launches["tvae"] == 0, f"the TVAE path launched the render "
          f"kernel {path_launches['tvae']} times")
    print(f"phase 17 (TVAE): {time.perf_counter() - t0:.1f} s (host clock); "
          f"launches {{'render': 0}} [{card}]")

    # 18. the CelebA family, which renders nothing
    renderer_cuda.launches = 0
    t0 = time.perf_counter()
    celeba(work=work, card=card, dev=dev, profiled_steps=profiled_steps)
    path_launches["celeba"] = renderer_cuda.launches
    check(path_launches["celeba"] == 0, f"the CelebA path launched the "
          f"render kernel {path_launches['celeba']} times")
    print(f"phase 18 (CelebA): {time.perf_counter() - t0:.1f} s (host "
          f"clock); launches {{'render': 0}} [{card}]")

    # 19. data parallelism in a world-1 NCCL group
    data_parallel(work=work, card=card, dev=dev, dataset=dataset, ckpt=ckpt,
                  path_launches=path_launches)

    # 20. the packed layout and CelebAMask-HQ preprocessing, which render
    # nothing
    packing_and_preprocess(root=root, work=work, card=card, dev=dev,
                           path_launches=path_launches)

    # 21. the library options (bf16 steps, uint8 storage) and the CDM study
    # cut
    library_options(card=card, dev=dev, dataset=dataset,
                    path_launches=path_launches,
                    profiled_steps=profiled_steps)

    # 22. the studies of tools/, cut
    studies(work=work, card=card, dev=dev, path_launches=path_launches)

    # 23. the CUDA-graph epoch runner against the eager one
    graphed_epochs(work=work, card=card, dev=dev, dataset=dataset,
                   path_launches=path_launches)

    # 24. the graphed runners of the other trainers against their eager
    # ones, the online trainers with the render kernel in the graph
    graphed_paths(work=work, card=card, dev=dev, dataset=dataset,
                  path_launches=path_launches)

    # 25. the capturable Adam against optax's update, which renders nothing
    capturable_adam(card=card, dev=dev)
    shutil.rmtree(work, ignore_errors=True)
    print(f"chip_smoke: phases 1-25 in {time.perf_counter() - t_start:.1f} s "
          f"(host clock) [{card}]")

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
