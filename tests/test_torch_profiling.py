"""The port's tooling on the CPU: ``utils/profiling.py`` (a torch.profiler
trace written as a Chrome trace and its events ranked by total time, the
step timer), ``--profile DIR`` on every trainer (the trace holds the
training drive's ops), and the reference's ``--platform`` (cpu runs on
the CPU and writes what ``--device cpu`` writes; gpu without a card, and
a contradicting ``--device``, stop before any work; other backends are
refused by name)."""
import os
import time

import pytest
import torch

from cdgvae_torch.cli import (dr_main, main, main_classifier, main_semi,
                              tabular_main, tabular_main_tvae)
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


def test_step_timer_reports():
    timer = profiling.StepTimer(batch_size=8)
    assert timer.report() == {}
    timer.start()
    time.sleep(0.01)
    timer.stop(n_steps=2)
    report = timer.report()
    assert 0 < report["steps_per_sec"] < 2 / 0.01
    assert report["images_per_sec"] == pytest.approx(
        8 * report["steps_per_sec"])
    timer.reset()
    assert timer.report() == {}


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
