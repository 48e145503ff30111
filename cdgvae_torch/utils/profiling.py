"""Tracing, step timing and the ranking of a trace's kernels (port of
``cdgvae_tpu/utils/profiling.py`` and the ranking half of ``cdgvae_tpu/
utils/xplane.py:174-203``).

* :func:`trace`: ``torch.profiler`` over the enclosed block, CPU activity
  and, where a GPU is present, CUDA activity, written as a Chrome trace
  ``<logdir>/<worker>.<time>.pt.trace.json`` (TensorBoard's profiler
  plugin and ``chrome://tracing`` read it). It records from the block's
  start to the end of its ``TRACE_STEPS``-th optimizer step, so that a
  long drive keeps a bounded trace. ``--profile DIR`` on every training
  CLI wraps its training drive in it. A step replayed from a CUDA graph
  runs no Python, so the graphed runners count it
  (:func:`count_replayed_step`, from ``train/scanned.py::CapturedStep``),
  and the step's capture counts nothing.
* :class:`StepTimer`: step times and rates; on a CUDA device timed with
  CUDA events (device time between ``start`` and ``stop``), else on the
  host clock.
* :func:`rank_ops` / :func:`print_ranking`: the newest trace under a
  directory, its events of one category (``"kernel"``: the device
  kernels) summed by name and ranked by total time.
* :class:`OpCounter`: the PyTorch operators one thread dispatches inside
  it (preprocessing's ``device_calls``).
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the optimizer steps a trace records (an InfoMax step takes two)
TRACE_STEPS = 20
# the open trace's step counters (one at most), for count_replayed_step
_COUNTERS: list = []


class OpCounter(TorchDispatchMode):
    """Counts in :attr:`ops` the operators that the entering thread hands
    PyTorch's dispatcher inside the ``with`` block (each call the caller
    makes, not the ones it runs inside; a dispatch mode is a thread's own,
    so other threads' operators are not counted). A kernel launched through
    ``ctypes`` is no operator: its wrapper counts it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here is compiled: without this, TorchDispatchMode wraps
        # __torch_dispatch__ in torch.compile's disable, whose first call
        # imports the compiler (2-8 s, inside the first chunk's time)
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def count_replayed_step() -> None:
    """Count a step that a CUDA graph replayed toward the open
    :func:`trace`'s window (its ``optimizer.step()`` ran no hook)."""
    for count in _COUNTERS:
        count()


@contextlib.contextmanager
def trace(logdir: str | None, steps: int = TRACE_STEPS):
    """Profile the enclosed block into a Chrome trace under ``logdir``
    (no-op when ``logdir`` is empty or None): from its start to the end
    of its ``steps``-th optimizer step (counted by a global
    ``Optimizer.step`` post-hook and :func:`count_replayed_step`), or to
    its end if that comes first."""
    if not logdir:
        yield
        return
    from torch.optim.optimizer import register_optimizer_step_post_hook
    from torch.profiler import (ProfilerAction, ProfilerActivity, profile,
                                tensorboard_trace_handler)

    def window(step: int) -> ProfilerAction:
        if step < steps - 1:
            return ProfilerAction.RECORD
        return (ProfilerAction.RECORD_AND_SAVE if step == steps - 1
                else ProfilerAction.NONE)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, schedule=window,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        def count(*_):
            # a step being captured into a CUDA graph has not run
            if not (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                prof.step()
        hook = register_optimizer_step_post_hook(count)
        _COUNTERS.append(count)
        try:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            hook.remove()
            _COUNTERS.remove(count)


class StepTimer:
    """Accumulates step times; ``report()`` returns steps/sec and
    images/sec (rows a second for a tabular batch). On a CUDA ``device``
    a ``start``/``stop`` pair is timed by CUDA events on the current
    stream, so ``stop`` waits for the device."""

    def __init__(self, batch_size: int, device: str | torch.device = "cpu"):
        self.batch_size = batch_size
        self._cuda = torch.device(device).type == "cuda"
        self.reset()

    def reset(self):
        self._t0 = None
        self._steps = 0
        self._elapsed = 0.0

    def start(self):
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, n_steps: int = 1):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self._elapsed += self._t0.elapsed_time(end) / 1e3
        else:
            self._elapsed += time.perf_counter() - self._t0
        self._steps += n_steps

    def report(self) -> dict:
        if self._elapsed == 0:
            return {}
        sps = self._steps / self._elapsed
        return {"steps_per_sec": sps,
                "images_per_sec": sps * self.batch_size}


def newest_trace(trace_dir: str) -> dict:
    """The newest ``*.pt.trace.json`` under ``trace_dir`` (recursive)."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .pt.trace.json under {trace_dir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        return json.load(f)


def op_totals(trace_dir: str, category: str = "kernel") -> dict[str, float]:
    """Total duration (ms) by name of the newest trace's complete events
    of ``category`` (``"kernel"``, ``"cpu_op"``, ``"gpu_memcpy"``...)."""
    totals: dict[str, float] = {}
    for ev in newest_trace(trace_dir).get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") == category:
            totals[ev["name"]] = totals.get(ev["name"], 0.0) \
                + ev.get("dur", 0) / 1e3
    return totals


def rank_ops(trace_dir: str, top: int = 25,
             category: str = "kernel") -> list[tuple[str, float]]:
    """Top events of a trace as (name, total ms), descending."""
    totals = op_totals(trace_dir, category)
    return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


def print_ranking(trace_dir: str, top: int = 25, steps: int | None = None,
                  category: str = "kernel") -> dict[str, float]:
    """Print the ranking with each event's share of the total; returns
    the totals."""
    totals = op_totals(trace_dir, category)
    total_ms = sum(totals.values())
    head = f"total {category} time: {total_ms:.3f} ms"
    if steps:
        head += f" over {steps} steps ({total_ms / steps * 1e3:.1f} us/step)"
    print(head)
    for name, ms in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:9.3f} ms  {100 * ms / max(total_ms, 1e-12):5.1f}%  "
              f"{name[:100]}")
    return totals


if __name__ == "__main__":  # python -m cdgvae_torch.utils.profiling DIR
    import sys

    print_ranking(sys.argv[1], top=int(sys.argv[2]) if len(sys.argv) > 2
                  else 25)
