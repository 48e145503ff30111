"""The dispatch of the studies of ``cdgvae_torch/tools/`` on the CPU.

On a CUDA device every study trains as the CLIs train there, one CUDA
graph a step with ``capturable`` Adams (``tools/cdm_seeds.py::
graphed_dispatch``); ``--eager`` keeps the eager runners. The card holds
graphed equal to eager (``chip_smoke.py`` phase 22). Here, on the CPU:
each tool's CLI has ``--eager``; the CPU stays eager, so a cut run writes
the same summary with and without ``--eager``, bit for bit but for the
wall times, and records ``"dispatch": "eager"``; and a run that asks for
graph mode (``eager=False``) on CPU tensors raises, as the runners do.
Cut runs: 1 seed, 1 epoch, 256 samples (DR: one configuration, 1 repeat
of 5 epochs; tabular: loan)."""
import json

import pytest
import torch

from cdgvae_torch.data.pendulum_dr import PendulumDRDataset
from cdgvae_torch.data.tabular.datasets import load_tabular
from cdgvae_torch.eval.tabular_inference import real_cpdag
from cdgvae_torch.tools import (cdm_seeds, dr_sweep, online_seeds, se_seeds,
                                tabular_seeds)

CUT = dict(cdm_seeds.CONFIG, epochs=1, n_samples=256, classifier_epochs=1,
           robustness_epochs=5)
# case -> (tool, its cut flags)
CASES = {
    "cdm": (cdm_seeds, []),
    "cdm semi": (cdm_seeds, ["--semi"]),
    "cdm infomax": (cdm_seeds, ["--model", "InfoMax"]),
    "se": (se_seeds, ["--epochs", "1", "--n", "256"]),
    "online": (online_seeds, []),
    "online semi": (online_seeds, ["--semi"]),
    "dr": (dr_sweep, ["--lams", "40", "--repeats", "1"]),
    "dr online": (dr_sweep, ["--lams", "40", "--repeats", "1", "--online"]),
    "tabular": (tabular_seeds, ["--datasets", "loan", "--epochs", "1"]),
    "tabular tvae": (tabular_seeds, ["--datasets", "loan", "--epochs", "1",
                                     "--tvae"]),
}
TOOLS = {"cdm_seeds": cdm_seeds, "se_seeds": se_seeds,
         "online_seeds": online_seeds, "dr_sweep": dr_sweep,
         "tabular_seeds": tabular_seeds}
WALL_KEYS = {"train_seconds", "train_s"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and these many small CPU ops on every core of every worker
    oversubscribe it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_every_tool_has_eager(name):
    tool = TOOLS[name]
    assert tool.get_args([]).eager is False
    assert tool.get_args(["--eager"]).eager is True


def _without_walls(obj):
    if isinstance(obj, dict):
        return {k: _without_walls(v) for k, v in obj.items()
                if k not in WALL_KEYS}
    if isinstance(obj, list):
        return [_without_walls(v) for v in obj]
    return obj


def _records(summary):
    return summary if isinstance(summary, list) else [summary]


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_stays_eager_and_records_the_dispatch(case, tmp_path,
                                                  monkeypatch):
    tool, flags = CASES[case]
    if hasattr(tool, "CONFIG"):
        monkeypatch.setattr(tool, "CONFIG", dict(tool.CONFIG, **{
            k: v for k, v in CUT.items() if k in tool.CONFIG
            or k == "robustness_epochs"}))
    summaries = []
    for extra in ([], ["--eager"]):
        out = tmp_path / f"s{len(summaries)}.json"
        tool.main(["--seeds", "1", "--device", "cpu", "--out", str(out),
                   *flags, *extra])
        summaries.append(json.loads(out.read_text()))
    for summary in summaries:
        for record in _records(summary):
            assert record["dispatch"] == "eager"
            assert record["device"] == "cpu"
    assert _without_walls(summaries[0]) == _without_walls(summaries[1])


GRAPH_ON_CPU = {
    "cdm": lambda: cdm_seeds.run_seed(1, CUT, device="cpu", eager=False),
    "cdm semi": lambda: cdm_seeds.run_seed(1, CUT, semi=True, device="cpu",
                                           eager=False),
    "cdm infomax": lambda: cdm_seeds.run_seed(
        1, dict(CUT, model="InfoMax"), device="cpu", eager=False),
    "cdm classifier": lambda: cdm_seeds.score_cdm(
        None, *_cdm_data(), 1, CUT, eager=False),
    "se": lambda: se_seeds.run_seed(1, CUT, device="cpu", eager=False),
    "online": lambda: online_seeds.run_seed(1, CUT, device="cpu",
                                            eager=False),
    "online semi": lambda: online_seeds.run_seed(1, CUT, semi=True,
                                                 device="cpu", eager=False),
    "dr": lambda: _dr(False),
    "dr online": lambda: _dr(True),
    "tabular": lambda: _tabular(False),
    "tabular tvae": lambda: _tabular(True),
}


def _cdm_data():
    from cdgvae_torch.data.pendulum import PendulumDataset

    ds = PendulumDataset(train=True, seed=1, n=256, device="cpu")
    return ds.x_data, ds.y_data


def _dr(online):
    cfg = dict(dr_sweep.CONFIG, epochs=1, n_samples=256,
               robustness_epochs=5)
    ds = PendulumDRDataset(train=True, seed=1, n=256, device="cpu")
    return dr_sweep.run_config(0.1, 40.0, ds.x_data, ds.y_data, ds, ds, cfg,
                               online=online, repeats=1, eager=False)


def _tabular(tvae):
    train = load_tabular("loan", train=True)
    test = load_tabular("loan", train=False)
    g_real = real_cpdag(train.frame, "loan")
    if tvae:
        return tabular_seeds.run_seed_tvae("loan", 1, 1, test, g_real, train,
                                           device="cpu", eager=False)
    return tabular_seeds.run_seed("loan", 1, 1, train, test, g_real,
                                  device="cpu", eager=False)


@pytest.mark.parametrize("case", sorted(GRAPH_ON_CPU))
def test_graph_mode_on_cpu_tensors_raises(case):
    with pytest.raises(ValueError, match="CUDA device"):
        GRAPH_ON_CPU[case]()


def test_dispatch_times_reads_each_summary_and_needs_a_card(monkeypatch):
    from cdgvae_torch.tools import dispatch_times

    assert dispatch_times.train_seconds({"train_seconds": [12.5]}) == 12.5
    assert dispatch_times.train_seconds([{"train_s": 3.5}]) == 3.5
    assert dispatch_times.train_seconds(
        {"loader_branch": "synthetic-fallback",
         "adult": {"per_seed": [{"seed": 1, "train_s": 7.0}]}}) == 7.0
    assert set(dispatch_times.STUDIES) >= {"cdm_seeds", "se_seeds",
                                           "online_seeds", "dr_sweep"}
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        dispatch_times.main(["--only", "cdm_seeds"])
