"""What the program's own instrumentation gives the per-layer metrics: the
host spans of its epoch drivers (``cdgvae_torch/utils/profiling.py::
span``: ``driver.step``, ``driver.stage``, ``driver.replay``,
``driver.epoch_end``, recorded as ``cpu_op`` events on the trace's clock)
and the device phases of its captured step (``profiling.phase_times``,
read by the program at its host sync an epoch while the profiler
records, from the epoch's last replay). A program without them gives
nothing here, and the readers return None."""
from __future__ import annotations


def intervals(trace, name: str) -> list:
    """The (start, end) of the window's host events named ``name``,
    clipped to the window, sorted."""
    return sorted((max(e["ts"], trace.lo), min(e["ts"] + e["dur"], trace.hi))
                  for e in trace.host if e["name"] == name)


def total_seconds(trace, name: str) -> float | None:
    """The summed time of the window's ``name`` spans, or None without
    one."""
    spans = intervals(trace, name)
    return sum(e - s for s, e in spans) / 1e6 if spans else None


def merged(spans) -> list:
    """Sorted (start, end) intervals with the overlapping ones joined."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap(a, b) -> float:
    """The length that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def phase_ms(phase: str) -> float | None:
    """The program's mean device time of ``phase`` of a replayed step
    over the traced window's reads (one an epoch, of its last replay), or
    None where it holds none."""
    from cdgvae_torch.utils import profiling
    times = getattr(profiling, "phase_times", None)
    return None if times is None else times.mean_ms(phase)
