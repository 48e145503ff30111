"""The readers of the program's spans and step phases on a made-up trace
and a stand-in recorder: each span's time over the window's steps or
epochs, the device's idle share inside the replay spans, the phases'
means, and
None from every reader that finds nothing to read (a program without the
spans, as the parent of the change that added them)."""
from types import SimpleNamespace

import pytest

from benchmark import spans, tracing
from benchmark.manifest import ROOT, load_module

SPAN_METRICS = ("step_host_us", "replay_host_us", "epoch_end_ms",
                "idle_in_replay_share")
PHASE_METRICS = ("forward_ms", "backward_ms", "optimizer_ms",
                 "post_update_ms")


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def metric(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def ctx(events, steps=2, epochs=1):
    return SimpleNamespace(trace=tracing.Trace(events), steps=steps,
                           cell=SimpleNamespace(
                               traffic={"trace_epochs": epochs}))


def made_up():
    """One epoch of two steps in a 1000 us window: each step a stage and a
    replay; the device busy 100-300 and 500-700; idle 0-100, 300-500 and
    700-1000, of which 250-300 and 450-500 lie inside the replays."""
    return [
        ev(tracing.WINDOW, "user_annotation", 0, 1000),
        ev("driver.step", "cpu_op", 10, 430),      # 10-440
        ev("driver.stage", "cpu_op", 20, 30),      # 20-50
        ev("driver.replay", "cpu_op", 50, 250),    # 50-300
        ev("cudaGraphLaunch", "cuda_runtime", 60, 200),
        ev("driver.step", "cpu_op", 440, 360),     # 440-800
        ev("driver.stage", "cpu_op", 441, 8),      # 441-449
        ev("driver.replay", "cpu_op", 450, 100),   # 450-550
        ev("driver.epoch_end", "cpu_op", 800, 150),
        ev("k", "kernel", 100, 200),
        ev("k", "kernel", 500, 200),
    ]


def test_span_totals_over_the_windows_steps_and_epochs():
    c = ctx(made_up(), steps=2, epochs=1)
    assert metric("step_host_us").read(c) == pytest.approx(790 / 2)
    assert metric("replay_host_us").read(c) == pytest.approx(350 / 2)
    assert metric("epoch_end_ms").read(c) == pytest.approx(0.15)
    c3 = ctx(made_up(), steps=6, epochs=3)
    assert metric("epoch_end_ms").read(c3) == pytest.approx(0.05)


def test_spans_are_clipped_to_the_window():
    events = made_up() + [ev("driver.step", "cpu_op", 950, 200)]
    # 950-1150 counts its 50 us inside the window
    assert metric("step_host_us").read(ctx(events)) == pytest.approx(
        840 / 2)


def test_only_idle_time_inside_replay_spans_counts():
    c = ctx(made_up())
    # replays 50-300 and 450-550 (350 us), idle inside them 50-100 and
    # 450-500 (100 us); the window's idle 600 of 1000 does not enter
    assert metric("idle_in_replay_share").read(c) == pytest.approx(
        100 * 100 / 350)
    # overlapping replay spans count their time once
    twice = made_up() + [ev("driver.replay", "cpu_op", 60, 40)]
    assert metric("idle_in_replay_share").read(ctx(twice)) == \
        pytest.approx(100 * 100 / 350)
    # replays over busy time only: no idle inside them
    busy = [e for e in made_up() if e["name"] != "driver.replay"] + [
        ev("driver.replay", "cpu_op", 120, 100),
        ev("driver.replay", "cpu_op", 520, 100)]
    assert metric("idle_in_replay_share").read(ctx(busy)) == 0.0
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.merged([(3, 5), (0, 4), (7, 8)]) == [(0, 5), (7, 8)]


def test_every_span_reader_returns_none_without_its_spans():
    bare = [e for e in made_up() if not e["name"].startswith("driver.")]
    for name in SPAN_METRICS:
        assert metric(name).read(ctx(bare)) is None, name
    assert metric("step_host_us").read(ctx(made_up(), steps=0)) is None
    # replay spans but no device activity
    quiet = [e for e in made_up() if e["cat"] != "kernel"]
    assert metric("idle_in_replay_share").read(ctx(quiet)) is None


class StubTimes:
    def __init__(self, means):
        self.means = means

    def mean_ms(self, phase):
        return self.means.get(phase)


def test_phase_readers_read_the_recorder(monkeypatch):
    from cdgvae_torch.utils import profiling
    monkeypatch.setattr(profiling, "phase_times", StubTimes(
        {"forward": 1.25, "backward": 2.5, "optimizer": 0.75,
         "post_update": 0.5}))
    got = {n: metric(n).read(None) for n in PHASE_METRICS}
    assert got == {"forward_ms": 1.25, "backward_ms": 2.5,
                   "optimizer_ms": 0.75, "post_update_ms": 0.5}
    monkeypatch.setattr(profiling, "phase_times", StubTimes(
        {"forward": 1.0, "backward": 1.0, "optimizer": 1.0}))
    assert metric("post_update_ms").read(None) is None


def test_phase_readers_return_none_without_a_recorder(monkeypatch):
    from cdgvae_torch.utils import profiling
    monkeypatch.delattr(profiling, "phase_times")
    for name in PHASE_METRICS:
        assert metric(name).read(None) is None, name
    monkeypatch.setattr(profiling, "phase_times", profiling.PhaseTimes(),
                        raising=False)
    for name in PHASE_METRICS:
        assert metric(name).read(None) is None, name
