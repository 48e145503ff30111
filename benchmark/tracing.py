"""The traced part of a window: a ``torch.profiler`` trace of the CPU and
the card over whole epochs, reduced to what the per-layer metrics read.

The window is marked by one annotation, ``benchmark.window``, from the
profiler's start to the last traced epoch's host sync. Within it:

* device intervals: every kernel, copy and memset on the card, clipped to
  the window; their union is the time the device was busy;
* runtime calls: the host's launches (kernels, graph replays, copies,
  memsets) through the CUDA runtime and driver;
* host operations: PyTorch operators and runtime calls, which name the
  idle gaps by what the host was doing in them.

The trace is written to a temporary file under ``TMPDIR`` and removed once
read.
"""
from __future__ import annotations

import json
import os
import tempfile

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


class Tracer:
    """Starts the profiler and the window's annotation; :meth:`stop` ends
    both (after a device sync) and returns the reduced :class:`Trace`."""

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def stop(self) -> "Trace":
        import torch
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return Trace(events)


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers,
    longest first."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return sorted((g for g in out if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


class Trace:
    """A trace's events inside the window (times in microseconds)."""

    def __init__(self, events: list):
        complete = [e for e in events if e.get("ph") == "X"
                    and "dur" in e and "ts" in e]
        marks = [e for e in complete if e.get("name") == WINDOW]
        if not marks:
            raise ValueError(f"the trace holds no {WINDOW} annotation")
        mark = max(marks, key=lambda e: e["dur"])
        self.lo = float(mark["ts"])
        self.hi = self.lo + float(mark["dur"])

        def inside(e):
            return e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo

        self.device = [e for e in complete
                       if e.get("cat") in DEVICE_CATS and inside(e)]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in complete if e.get("cat") in HOST_CATS
                     and e.get("name") != WINDOW and inside(e)]
        self.launches = [e for e in self.host if e["name"] in LAUNCHES]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def _clipped(self, events):
        return [(max(e["ts"], self.lo), min(e["ts"] + e["dur"], self.hi))
                for e in events]

    def busy_s(self) -> float:
        """Seconds of the window in which the device ran anything."""
        return union_length(self._clipped(self.device)) / 1e6

    def kernel_seconds(self, match) -> float:
        """Total device time of the kernels whose name ``match``es."""
        return sum(e["dur"] for e in self.kernels if match(e["name"])) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        totals: dict = {}
        for e in self.device:
            totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"] / 1e6
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), s] for n, s in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle stretches of the device: [what the host was
        doing (the innermost host operation over the stretch's middle),
        seconds]."""
        out = []
        for s, e in gaps(self._clipped(self.device), self.lo,
                         self.hi)[:top]:
            mid = (s + e) / 2
            over = [h for h in self.host
                    if h["ts"] <= mid <= h["ts"] + h["dur"]]
            name = min(over, key=lambda h: h["dur"])["name"] if over \
                else "host Python (no operator)"
            out.append([_short(name), (e - s) / 1e6])
        return out


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."
