"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; their files under ``benchmark/`` say how the program is set
up and driven (``manifest.py``). A run:

1. sets up the program as its CLI does and drives the CLI's runner; the
   first ``warmup_epochs`` epochs (the eager first step, the CUDA graph's
   capture, the first replays) are set-up, and their first steps are
   observed for the comparison (``program.py``);
2. measures whole epochs (the program syncs the host once an epoch) until
   ``--seconds`` have passed: ``train_images_per_s`` is every image of
   those epochs over the time from the window's start to the last
   epoch's sync, ``epoch_ms_p95`` the 95th percentile (nearest rank) of
   their times. With ``--trace 1`` it runs the same epochs untraced and
   then traces the next ``trace_epochs`` with ``torch.profiler``, so the
   trace sees the regime the window ends in, and reports the per-layer
   metrics (``metrics/<name>.py``), the device's busy seconds and a
   breakdown;
3. reads the card's peak memory, checks that no module of JAX or of the
   JAX package was imported, frees the program's state, runs the plain
   reference over the same first steps and compares (``compare.py``).

The last line of standard output is one JSON object; the numbers compared
and their limits end standard error too. Without a CUDA device, or with
fewer than the cell asks for, it exits 2 and prints no result. Where a
module of JAX or of the JAX package is loaded once the window has closed,
or before the result is printed, it exits 3 and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cdgvae_tpu")
# the program's kernel and compiler caches, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


class WindowClosed(Exception):
    """Raised from the epoch callback to leave the program's runner."""


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]


class Window:
    """The epoch callback: ends set-up after ``warmup`` epochs, then times
    epochs until ``seconds`` have passed; with a ``tracer``, it then
    traces ``trace_epochs`` more."""

    def __init__(self, seconds: float, warmup: int, t0: float,
                 tracer=None, trace_epochs: int = 0):
        self.seconds, self.warmup, self.t0 = seconds, warmup, t0
        self.tracer, self.trace_epochs = tracer, trace_epochs
        self.epochs, self.losses = [], []
        self.traced = None  # the index of the first traced epoch
        self.setup_s = self.start = self.last = self.trace = None

    def on_epoch(self, epoch: int, metrics: dict) -> None:
        now = time.perf_counter()
        if epoch + 1 < self.warmup:
            return
        if epoch + 1 == self.warmup:
            self.setup_s = now - self.t0
            self.start = self.last = time.perf_counter()
            return
        self.epochs.append(now - self.last)
        self.losses.append(metrics.get("loss", math.nan))
        if self.traced is not None:
            if len(self.epochs) - self.traced >= self.trace_epochs:
                self.trace = self.tracer.stop()
                raise WindowClosed
        elif now - self.start >= self.seconds:
            if self.tracer is None:
                self.last = now
                raise WindowClosed
            self.traced = len(self.epochs)
            self.tracer.start()
            now = time.perf_counter()
        self.last = now


class Context:
    """What a per-layer metric's reader gets."""

    def __init__(self, cell, trace, steps: int, products: dict,
                 device_name: str):
        self.cell, self.trace, self.steps = cell, trace, steps
        self.products = products
        card = next((c for c in cell.peaks["cards"]
                     if c["match"] in device_name), None)
        self.peak_bytes = card["bytes_per_s"] if card else None
        self.peak_flops = card["flops_per_s"].get(
            cell.traffic["dtype"]) if card else None


def drive(cell, seed: int, seconds: float, trace: bool, device,
          t0: float = T0):
    """Set the cell's program up and drive it through the window; then
    read the peak memory, check the loaded modules and free the program's
    state. Returns (session, window, the program's readings, peak
    bytes)."""
    import torch

    from benchmark.program import Observer
    from benchmark.tracing import Tracer

    observer = Observer()
    t_imports = time.perf_counter()
    session = cell.module().Session(cell.config, cell.traffic, seed, device,
                                    observer)
    t_session = time.perf_counter()
    window = Window(seconds, cell.traffic["warmup_epochs"], t0,
                    Tracer() if trace else None,
                    cell.traffic["trace_epochs"])
    try:
        session.drive(window.on_epoch)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the runner ended before the window closed")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package were "
                           f"loaded: {', '.join(found)}")
    if window.setup_s is not None:
        print(f"set-up {window.setup_s:.3f} s: {t_imports - t0:.3f} s to "
              f"the harness's imports, {t_session - t_imports:.3f} s to the "
              f"program's session (its imports, data, model, optimizer), "
              f"{t0 + window.setup_s - t_session:.3f} s of warm-up epochs",
              file=sys.stderr)
    prog = observer.readings()
    observer.attach(None, None)
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference's products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return session, window, prog, peak_bytes


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0) -> dict:
    """One run of ``cell`` on ``device``: the result object, or raises."""
    import torch

    from benchmark import compare

    session, window, prog, peak_bytes = drive(cell, seed, seconds, trace,
                                              device, t0)
    cuda = torch.device(device).type == "cuda"
    module = cell.module()
    spe, ips = session.steps_per_epoch, session.images_per_step
    ref = session.reference()
    correct, checks = compare.judge(compare.gaps(prog, ref), cell.limits)

    steps = len(window.epochs) * spe
    failed = spe * sum(not math.isfinite(v) for v in window.losses)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1,
                   "memory_peak_bytes": peak_bytes}
    metrics, breakdown = {}, None
    if trace:
        products = module.products_per_step(cell.config, cell.traffic)
        ctx = Context(cell, window.trace,
                      (len(window.epochs) - window.traced) * spe, products,
                      device_info["kind"])
        for m in cell.per_layer:
            value = cell.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=window.trace.busy_s(),
                           window_s=window.trace.window_s)
        breakdown = {"device_ops": window.trace.device_ops(),
                     "idle_gaps": window.trace.idle_gaps()}
    else:
        elapsed = window.last - window.start
        values = {"train_images_per_s": steps * ips / elapsed,
                  "epoch_ms_p95": 1e3 * percentile(window.epochs, 0.95),
                  "setup_s": window.setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        q = [1e3 * v for v in sorted(window.epochs)]
        print(f"window: {len(window.epochs)} epochs of {spe} steps in "
              f"{elapsed:.3f} s; epoch_ms_p95 over {len(q)} epoch times; "
              f"epoch ms min {q[0]:.3f} median {q[len(q) // 2]:.3f} "
              f"max {q[-1]:.3f}", file=sys.stderr)
    missing = names - set(metrics)
    if missing:
        print(f"not read in this run: {sorted(missing)}", file=sys.stderr)
    result = {"correct": correct and failed == 0, "attempted": steps,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        path = ROOT / "build" / "benchmark_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)

    from benchmark.manifest import Cell
    cell = Cell(args.workload)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available: no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.trace:
        print(f"card: {_power_line()}", file=sys.stderr)
    return emit(run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device))


def emit(result: dict) -> int:
    """Print the numbers compared at the end of standard error and the
    result line, unless a module of JAX or of the JAX package has been
    loaded by now (the reference, a metric's reader or what they import):
    then name it and print no result."""
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: "
              f"{', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}, worst "
              f"at {c['at']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
