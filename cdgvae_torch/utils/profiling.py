"""Tracing, the program's spans and step phases, and the ranking of a
trace's kernels (port of ``cdgvae_tpu/utils/profiling.py`` and the ranking
half of ``cdgvae_tpu/utils/xplane.py:174-203``).

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
* :func:`span`: a named host span of the epoch drivers
  (``driver.step``, ``driver.stage``, ``driver.replay``,
  ``driver.epoch_end``), a ``cpu_op`` event on the
  trace's clock. Tracing is on exactly while a ``torch.profiler`` records
  in the process; off, a span costs one read of the profiler's flag and
  is a shared no-op.
* :func:`mark`: the end of a phase of a training step (:data:`PHASES`),
  a timing CUDA event that the step's capture records into its graph
  (:func:`capturing`), so every replay stamps it on the device; outside a
  capture it does nothing. While tracing, the epoch drivers read the
  latest replay's phase times at their one host sync an epoch into
  :data:`phase_times` (:class:`PhaseTimes`): one reading an epoch, of
  its last replay.
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

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode

# the optimizer steps a trace records (an InfoMax step takes two)
TRACE_STEPS = 20
# the open trace's step counters (one at most), for count_replayed_step
_COUNTERS: list = []
# a training step's device phases, each ended by the mark of its name
PHASES = ("forward", "backward", "optimizer", "post_update")
# what a span is while no profiler records
_OFF = contextlib.nullcontext()
# the marks of the capture in progress (set by capturing)
_capture: StepMarks | None = None


def span(name: str):
    """A context that records the host span ``name`` into the running
    profiler's trace; while none records, the shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


class StepMarks:
    """The timing events one captured step records, in order: the body's
    start, then the end of each phase it marks (:func:`mark`). They are
    event-record nodes of the graph, so after a replay and a sync each
    holds that replay's time."""

    def __init__(self):
        self.events: list = []

    def record(self, name: str) -> None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.events.append((name, event))

    def elapsed(self) -> list:
        """(phase, device ms) from each mark to the next, of the latest
        replay; the events must be complete."""
        return [(name, start.elapsed_time(end)) for (_, start), (name, end)
                in zip(self.events, self.events[1:])]


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture of a step: records the body's start
    and lets :func:`mark` record into the :class:`StepMarks` it yields."""
    global _capture
    marks = StepMarks()
    marks.record("start")
    _capture = marks
    try:
        yield marks
    finally:
        _capture = None


def mark(phase: str) -> None:
    """The end of ``phase`` (one of :data:`PHASES`) of the step being
    captured; outside a capture nothing."""
    if _capture is not None:
        _capture.record(phase)


class PhaseTimes:
    """Running sums and counts of the replays' device phases (ms), by
    phase. The graphed runners note each replay's marks
    (:attr:`latest`); the epoch drivers call :meth:`read` right after
    their host sync, which adds the latest replay's phases once, and only
    while tracing."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sums: dict = {}
        self.counts: dict = {}
        self.latest: StepMarks | None = None

    def read(self) -> None:
        if self.latest is None or not _autograd_profiler._is_profiler_enabled:
            return
        for name, ms in self.latest.elapsed():
            self.sums[name] = self.sums.get(name, 0.0) + ms
            self.counts[name] = self.counts.get(name, 0) + 1
        self.latest = None

    def mean_ms(self, phase: str) -> float | None:
        """The mean of ``phase`` over the reads, or None without one."""
        n = self.counts.get(phase)
        return self.sums[phase] / n if n else None


phase_times = PhaseTimes()


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
