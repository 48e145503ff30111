"""The trace's reductions and the window's arithmetic on made-up events:
the busy union, the idle gaps and what names them, the whole-window rate
and the 95th percentile over a window that holds one stall, and the
traced epochs after the timed ones."""
import pytest

from benchmark import run, tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def made_up_trace():
    return tracing.Trace([
        ev(tracing.WINDOW, "user_annotation", 0, 1000),
        ev("k1", "kernel", 100, 200),      # 100-300
        ev("k2", "kernel", 250, 150),      # 250-400, overlaps k1
        ev("copy", "gpu_memcpy", 400, 100),  # 400-500
        ev("k1", "kernel", 900, 200),      # 900-1100, cut at the window
        ev("outside", "kernel", 2000, 50),
        ev("cudaGraphLaunch", "cuda_runtime", 90, 5),
        ev("cudaLaunchKernel", "cuda_runtime", 95, 3),
        ev("aten::randperm", "cpu_op", 520, 300),   # over the long gap
        ev("cudaStreamSynchronize", "cuda_runtime", 0, 60),
    ])


def test_busy_is_the_union_of_device_intervals():
    t = made_up_trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(500e-6)  # 100-500 and 900-1000
    assert len(t.kernels) == 3 and len(t.launches) == 2
    assert t.kernel_seconds(lambda n: n == "k1") == pytest.approx(400e-6)


def test_idle_gaps_longest_first_named_by_the_host():
    gaps = made_up_trace().idle_gaps()
    assert gaps[0] == ["aten::randperm", pytest.approx(400e-6)]
    assert gaps[1] == ["cudaGraphLaunch", pytest.approx(100e-6)] \
        or gaps[1][1] == pytest.approx(100e-6)
    assert tracing.union_length([(0, 2), (1, 3), (5, 6)]) == 4


def test_window_rate_and_p95_over_a_stall(monkeypatch):
    # the warm-up epoch ends at 1 s (read twice: its end, the window's
    # start), then 20 epochs of 10 ms, one of 500 ms, 10 ms ones
    ends = [1.0 + 0.01 * i for i in range(1, 21)] + [1.7]
    ends += [1.7 + 0.01 * i for i in range(1, 40)]
    clock = iter([1.0, 1.0] + ends)
    monkeypatch.setattr(run.time, "perf_counter", lambda: next(clock))
    w = run.Window(seconds=0.9, warmup=1, t0=0.0)
    with pytest.raises(run.WindowClosed):
        for epoch in range(100):
            w.on_epoch(epoch, {"loss": 1.0})
    assert w.setup_s == pytest.approx(1.0)
    assert max(w.epochs) == pytest.approx(0.5)
    assert w.last - w.start >= 0.9 > w.last - w.start - 0.01 - 1e-9
    assert w.last - w.start == pytest.approx(sum(w.epochs))
    n = len(w.epochs)
    assert run.percentile(w.epochs, 0.95) == pytest.approx(
        sorted(w.epochs)[-(-95 * n // 100) - 1])
    assert run.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                           15, 16, 17, 18, 19, 100], 0.95) == 19
    assert run.percentile(list(range(1, 101)), 0.95) == 95


class FakeTracer:
    def __init__(self):
        self.calls = []

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")
        return "trace"


def test_the_trace_follows_the_timed_epochs(monkeypatch):
    # epochs of 100 ms: the timed part ends at the first end 0.5 s past
    # the window's start, then three epochs are traced
    clock = iter([1.0, 1.0] + [1.0 + 0.1 * i for i in range(1, 40)])
    monkeypatch.setattr(run.time, "perf_counter", lambda: next(clock))
    tracer = FakeTracer()
    w = run.Window(seconds=0.5, warmup=1, t0=0.0, tracer=tracer,
                   trace_epochs=3)
    with pytest.raises(run.WindowClosed):
        for epoch in range(100):
            w.on_epoch(epoch, {"loss": 1.0})
            assert tracer.calls in ([], ["start"]) or epoch == w.traced + 3
    assert tracer.calls == ["start", "stop"] and w.trace == "trace"
    assert w.traced == 5 and len(w.epochs) == w.traced + 3
