"""The port's tooling: ``utils/profiling.py`` (a torch.profiler trace
written as a Chrome trace and its events ranked by total time; the epoch
drivers' spans and the captured step's phase marks), ``--profile DIR`` on
every trainer (the trace holds the training drive's ops), and the
reference's ``--platform`` (cpu runs on the CPU and writes what
``--device cpu`` writes; gpu without a card, and a contradicting
``--device``, stop before any work; other backends are refused by name).

On the CPU: no span is recorded while no profiler runs; under one, the
eager runners write one ``driver.step`` a step and one
``driver.epoch_end`` an epoch, after its steps; a phase mark outside a
capture does nothing and leaves the step's outputs as they were. On the
card (marker ``cuda``, no JAX here; ``python -m pytest --noconftest -q
tests/test_torch_profiling.py -m cuda``): each step of a graphed runner
holds one ``driver.stage`` and one ``driver.replay``, and each replay
one ``cudaGraphLaunch``; the phases read at the epoch's sync (those of
its last replay) are positive and sum to the mean device extent of the
epoch's replays.
"""
import json
import os
from functools import partial

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cdgvae_torch.cli import (dr_main, main, main_classifier, main_semi,
                              tabular_main, tabular_main_tvae)
from cdgvae_torch.cli.common import run_online_training
from cdgvae_torch.train.loop import run_epochs, run_epochs_semi
from cdgvae_torch.train.steps import step_from_loss
from cdgvae_torch.utils import profiling
from cdgvae_torch.utils.checkpoint import load_checkpoint

SMALL = ["--image_size", "16", "--n_samples", "96", "--batch_size", "32",
         "--epochs", "1"]
# trainer: (its CLI, flags, the training step's op the trace must hold)
TRAINERS = {
    "main": (main, SMALL, "aten::mm"),
    "main --eager": (main, SMALL + ["--eager"], "aten::mm"),
    "main --online": (main, SMALL + ["--online"], "aten::mm"),
    "main_semi": (main_semi, SMALL + ["--labeled_ratio", "0.3",
                                      "--batch_sizeL", "8"], "aten::mm"),
    "dr_main": (dr_main, SMALL, "aten::mm"),
    "main_classifier": (main_classifier, SMALL, "aten::bmm"),
    "tabular_main": (tabular_main, ["--epochs", "1"], "aten::mm"),
    "tabular_main_tvae": (tabular_main_tvae, ["--epochs", "1",
                                              "--batch_size", "1024"],
                          "aten::log_softmax"),
}


def test_trace_writes_a_ranked_chrome_trace(tmp_path, capsys):
    with profiling.trace(None):  # no-op
        pass
    x = torch.randn(64, 32)
    with profiling.trace(str(tmp_path / "t")):
        for _ in range(3):
            (x @ x.T).relu().sum()
    files = [f for f in os.listdir(tmp_path / "t")
             if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    ranked = profiling.rank_ops(str(tmp_path / "t"), top=5,
                                category="cpu_op")
    assert 0 < len(ranked) <= 5
    assert [ms for _, ms in ranked] == sorted((ms for _, ms in ranked),
                                              reverse=True)
    names = dict(profiling.rank_ops(str(tmp_path / "t"), top=100,
                                    category="cpu_op"))
    assert {"aten::mm", "aten::relu"} <= set(names)
    # no device kernels in a CPU trace
    assert profiling.rank_ops(str(tmp_path / "t")) == []
    totals = profiling.print_ranking(str(tmp_path / "t"), top=3, steps=3,
                                     category="cpu_op")
    said = capsys.readouterr().out
    assert said.startswith("total cpu_op time:") and "us/step" in said
    assert len(said.splitlines()) == 4 and totals == names
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        profiling.rank_ops(str(tmp_path / "empty"))


def test_trace_stops_after_its_window_of_optimizer_steps(tmp_path):
    w = torch.nn.Parameter(torch.randn(8, 8))
    opt = torch.optim.SGD([w], lr=0.1)
    with profiling.trace(str(tmp_path / "t"), steps=2):
        for _ in range(5):
            opt.zero_grad()
            (w @ w).sum().backward()
            opt.step()
    events = profiling.op_totals(str(tmp_path / "t"),
                                 category="user_annotation")
    steps = [n for n in events if n.startswith("Optimizer.step")]
    assert steps
    trace = profiling.newest_trace(str(tmp_path / "t"))
    assert sum(ev.get("name", "").startswith("Optimizer.step")
               and ev.get("cat") == "user_annotation"
               for ev in trace["traceEvents"]) == 2


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_profile_traces_the_training_drive(tmp_path, trainer):
    cli, args, op = TRAINERS[trainer]
    trace_dir = tmp_path / "trace"
    cli.main(["--device", "cpu", *args, "--assets_dir", str(tmp_path),
              "--profile", str(trace_dir)])
    names = dict(profiling.rank_ops(str(trace_dir), top=1000,
                                    category="cpu_op"))
    assert op in names and names[op] > 0
    # the optimizer's update ran inside the traced drive
    steps = dict(profiling.rank_ops(str(trace_dir),
                                    category="user_annotation"))
    assert any(n.startswith("Optimizer.step") for n in steps)


def test_platform_cpu_runs_as_device_cpu(tmp_path):
    for out, flags in ((tmp_path / "p", ["--platform", "cpu"]),
                       (tmp_path / "d", ["--device", "cpu"]),
                       (tmp_path / "both", ["--platform", "CPU", "--device",
                                            "cpu"])):
        tabular_main.main(flags + ["--epochs", "1", "--assets_dir",
                                   str(out)])
    ck = {k: load_checkpoint(str(tmp_path / k / "tabular_CDGVAE_loan"))
          for k in ("p", "d", "both")}
    assert ck["p"]["config"]["device"] == "cpu"
    assert ck["p"]["config"]["platform"] == "cpu"
    with open(tmp_path / "p" / "tabular_CDGVAE_loan" / "state.pkl",
              "rb") as f:
        raw = f.read()
    for k in ("d", "both"):
        with open(tmp_path / k / "tabular_CDGVAE_loan" / "state.pkl",
                  "rb") as f:
            assert f.read() == raw


@pytest.mark.parametrize("flags,said", [
    (["--platform", "tpu"], "--platform tpu is not supported"),
    (["--platform", "cpu", "--device", "cuda"],
     "--platform cpu contradicts --device cuda"),
    (["--device", "cuda", "--platform", "cpu"],
     "--platform cpu contradicts --device cuda"),
])
def test_platform_refusals(tmp_path, capsys, flags, said):
    with pytest.raises(SystemExit):
        tabular_main_tvae.main(flags + ["--epochs", "1", "--assets_dir",
                                        str(tmp_path)])
    assert said in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_platform_gpu_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tabular_main.main(["--platform", "gpu", "--epochs", "1",
                           "--assets_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


# the eager runners' spans: 40 rows (online: a 53-sample DGP's 40 train
# rows) in batches of 8, 5 steps an epoch, 2 epochs
ROWS, BATCH, EPOCHS = 40, 8, 2


def _linear(seed: int = 0):
    """A linear regression, its Adam, and its loss for the runners."""
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    def loss_fn(x, y, generator=None):
        loss = ((model(x) - y) ** 2).mean()
        return loss, {"loss": loss, "scale": model.weight.abs().mean()}
    return model, opt, loss_fn


def _events(prof, path) -> list:
    """The complete events of a finished profiler's Chrome trace."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"]


def _named(events, name) -> list:
    return sorted((e for e in events if e.get("name") == name),
                  key=lambda e: e["ts"])


def _within(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] \
        and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _run_eager(runner: str):
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(ROWS, 4, generator=g), torch.randn(ROWS, 2,
                                                           generator=g)
    model, opt, loss_fn = _linear()
    if runner == "fixed":
        run_epochs(step_from_loss(loss_fn, opt), x, y, seed=0,
                   epochs=EPOCHS, batch_size=BATCH)
    elif runner == "semi":
        def semi_loss(x_u, x_l, y_l, generator=None):
            loss, metrics = loss_fn(x_l, y_l)
            return loss + model(x_u).pow(2).mean(), metrics
        run_epochs_semi(step_from_loss(semi_loss, opt), x, x[:12], y[:12],
                        seed=0, epochs=EPOCHS, batch_size=BATCH,
                        batch_size_l=4)
    else:
        def make_batches(bs):
            return lambda gen, offset: (torch.randn(bs, 4, generator=gen),
                                        torch.randn(bs, 2, generator=gen))
        config = {"batch_size": BATCH, "n_samples": 53, "seed": 0,
                  "epochs": EPOCHS}
        run_online_training(config, loss_fn=loss_fn, optimizer=opt,
                            device="cpu", start_epoch=0,
                            on_epoch=lambda epoch, metrics: None,
                            sample_batch_builder=make_batches)


def test_a_span_records_nothing_without_a_profiler(monkeypatch, tmp_path):
    assert not torch.autograd.profiler._is_profiler_enabled
    made = []

    def record(name):
        made.append(name)
        return profiling._OFF
    monkeypatch.setattr(profiling, "_RecordFunctionFast", record)
    first, second = profiling.span("driver.step"), profiling.span("other")
    assert first is second is profiling._OFF
    with first:
        pass
    _run_eager("fixed")
    assert made == []
    monkeypatch.undo()
    # the runners' spans of that drive reach no later trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("inside"):
            pass
    names = {e["name"] for e in _events(prof, tmp_path / "t.json")}
    assert "inside" in names and not {"driver.step",
                                      "driver.epoch_end"} & names


@pytest.mark.parametrize("runner", ["fixed", "semi", "online"])
def test_eager_runners_write_a_span_a_step_and_an_epoch_end(runner,
                                                            tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_eager(runner)
    events = _events(prof, tmp_path / "t.json")
    driver = sorted((e for e in events
                     if e["name"].startswith("driver.")),
                    key=lambda e: e["ts"])
    steps = ROWS // BATCH
    epoch = steps * ["driver.step"] + ["driver.epoch_end"]
    assert [e["name"] for e in driver] == EPOCHS * epoch
    assert all(e["cat"] in ("cpu_op", "user_annotation") for e in driver)
    # each epoch's spans end before the next starts: its steps before its
    # epoch end
    assert all(a["ts"] + a["dur"] <= b["ts"]
               for a, b in zip(driver, driver[1:]))
    # the update ran inside the steps
    updates = [e for e in events if e["name"].startswith("Optimizer.step")]
    in_steps = [s for s in driver if s["name"] == "driver.step"]
    assert len(updates) == EPOCHS * steps and all(
        any(_within(u, s) for s in in_steps) for u in updates)


def test_a_mark_outside_a_capture_does_nothing(monkeypatch):
    assert profiling._capture is None

    def record(self, name):
        raise AssertionError(f"{name} recorded outside a capture")
    monkeypatch.setattr(profiling.StepMarks, "record", record)
    for phase in profiling.PHASES:
        profiling.mark(phase)
    # the step with its marks against the same step written out plainly
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(8, 4, generator=g), torch.randn(8, 2, generator=g)
    model, opt, loss_fn = _linear()
    step = step_from_loss(loss_fn, opt)
    plain, plain_opt, plain_loss = _linear()
    for _ in range(3):
        out = step(x, y)
        plain_opt.zero_grad(set_to_none=True)
        loss, metrics = plain_loss(x, y)
        loss.backward()
        plain_opt.step()
        assert out.keys() == metrics.keys() and all(
            torch.equal(out[k], metrics[k].detach()) for k in out)
    for p, q in zip(model.parameters(), plain.parameters()):
        assert torch.equal(p, q)


def test_phase_times_read_each_replay_once_and_only_while_tracing():
    class Replayed:  # a replay's marks, read as (phase, ms)
        def elapsed(self):
            return [("forward", 1.5), ("backward", 2.0)]

    times = profiling.PhaseTimes()
    times.latest = Replayed()
    times.read()  # no profiler: nothing read
    assert times.counts == {} and times.mean_ms("forward") is None
    with profile(activities=[ProfilerActivity.CPU]):
        times.read()
        times.read()  # the same replay: read once
        times.latest = Replayed()
        times.read()
    times.latest = Replayed()
    times.read()
    assert times.counts == {"forward": 2, "backward": 2}
    assert times.mean_ms("forward") == 1.5
    assert times.mean_ms("backward") == 2.0
    assert times.mean_ms("post_update") is None
    times.reset()
    assert times.counts == {} and times.latest is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step runs on the "
                    "card")
    from cdgvae_torch.cli.celeba_main import float32_and_repeatable
    float32_and_repeatable()
    return torch.device("cuda")


def _graphed(case: str, dev, on_epoch) -> None:
    """Two epochs of a graphed runner at a small size (the first makes
    the eager step and the capture), ``on_epoch`` after each."""
    from cdgvae_torch.data.pendulum import PendulumDataset
    from cdgvae_torch.factory import build_celeba_model, build_pendulum_model
    from cdgvae_torch.models.sagan import sn_refresh
    from cdgvae_torch.train.celeba_steps import make_celeba_step
    from cdgvae_torch.train.online import pendulum_batch_fn
    from cdgvae_torch.train.scanned import NoisePlan, make_supervised_loss_fn
    from cdgvae_torch.train.steps import make_optimizer, make_train_step

    if case == "celeba":
        from cdgvae_torch.data.celeba import CelebADataset
        config = dict(img_size=32, conv_dim=8, causal_structure=0,
                      latent_dim=6, node=6, scm="linear", flow_num=1,
                      inverse_loop=100)
        data = CelebADataset(data_dir="", train=True, img_size=32, seed=3)
        x = torch.as_tensor(data.x_data[:12], device=dev)
        y = torch.as_tensor(data.y_data[:12], device=dev)
        model = build_celeba_model(config, device=dev, seed=3)
        opt = make_optimizer(model, 1e-3, capturable=True)
        run_epochs(make_celeba_step(model, opt, 0.1, 5.0), x, y, seed=3,
                   epochs=2, batch_size=4, on_epoch=on_epoch,
                   post_update=partial(sn_refresh, model),
                   graph_noise=partial(NoisePlan, model))
        return
    config = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                  inverse_loop=100, factor=[1, 1, 2], image_size=16,
                  adjacency_scaling=True)
    model, _ = build_pendulum_model(config, device=dev, seed=3)
    opt = make_optimizer(model, 1e-3, capturable=True)
    if case == "fixed":
        data = PendulumDataset(image_size=16, train=True, seed=3, n=64,
                               device=dev)
        run_epochs(make_train_step(model, opt, 0.1, 5.0), data.x_data,
                   data.y_data, seed=3, epochs=2, batch_size=8,
                   on_epoch=on_epoch, graph_noise=partial(NoisePlan, model))
        return
    run_online_training(
        {"batch_size": 8, "n_samples": 64, "seed": 3, "epochs": 2},
        loss_fn=make_supervised_loss_fn(model, 0.1, 5.0), optimizer=opt,
        device=dev, start_epoch=0, on_epoch=on_epoch,
        sample_batch_builder=lambda bs: pendulum_batch_fn(bs, 16,
                                                          device=dev),
        graph_noise=partial(NoisePlan, model))


def _traced_second_epoch(case: str, dev, path) -> list:
    """The events of a trace of the second epoch alone (started and
    stopped from the epoch callback, as the benchmark traces). The epoch
    starts behind about 50 ms of device work, so that the host has
    launched each replay before the device reaches it, as in the
    benchmark's cells: a replay launched onto an idle device starts its
    first kernel about 0.1 ms after its start mark."""
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])

    def on_epoch(epoch, metrics):
        if epoch == 0:
            prof.start()
            torch.cuda._sleep(100_000_000)
        else:
            prof.stop()
    profiling.phase_times.reset()
    try:
        _graphed(case, dev, on_epoch)
    finally:
        if torch.autograd.profiler._is_profiler_enabled:
            prof.stop()
    return _events(prof, path)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fixed", "online"])
def test_a_graphed_step_holds_a_stage_and_a_replay(cuda_device, case,
                                                   tmp_path):
    events = _traced_second_epoch(case, cuda_device, tmp_path / "t.json")
    steps, stages, replays, launches = (
        _named(events, n) for n in ("driver.step", "driver.stage",
                                    "driver.replay", "cudaGraphLaunch"))
    assert len(steps) == 6 and len(_named(events, "driver.epoch_end")) == 1
    for s in steps:
        assert sum(_within(t, s) for t in stages) == 1
        assert sum(_within(r, s) for r in replays) == 1
    assert len(replays) == len(launches) == 6
    for r in replays:
        assert sum(_within(g, r) for g in launches) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fixed", "online", "celeba"])
def test_the_phases_sum_to_the_replays_device_extent(cuda_device, case,
                                                     tmp_path):
    events = _traced_second_epoch(case, cuda_device, tmp_path / "t.json")
    phases = ["forward", "backward", "optimizer"] + (
        ["post_update"] if case == "celeba" else [])
    times = profiling.phase_times
    assert set(times.counts) == set(phases)
    assert all(times.counts[p] == 1 and times.mean_ms(p) > 0
               for p in phases)
    # each replay's extent: its kernels, matched to its launch by the
    # correlation id
    extents = []
    for launch in _named(events, "cudaGraphLaunch"):
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and e.get("args", {}).get("correlation")
                   == launch["args"]["correlation"]]
        assert kernels
        extents.append((max(e["ts"] + e["dur"] for e in kernels)
                        - min(e["ts"] for e in kernels)) / 1e3)
    assert extents
    total = sum(times.mean_ms(p) for p in phases)
    assert total == pytest.approx(sum(extents) / len(extents), rel=0.05)
