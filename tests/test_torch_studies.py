"""The studies of ``cdgvae_torch/tools/`` against the JAX package's
scripts: ``se_seeds``, ``online_seeds``, ``dr_sweep`` and
``tabular_seeds`` take the same flags with the same defaults (plus
``--device``, ``--init``, ``--first_seed`` and ``--eager``) and write every key of the
JAX script's summary, in a CPU run cut to 1 seed, 1 epoch and 256 samples
(DR: one configuration, 1 repeat; tabular: loan, 1 epoch); ``cdm_seeds --init jax`` trains from the JAX package's initial
parameters with the protected CDM cells exactly 0.0; and
``cdm_seeds.merge_summaries`` of two calls equals one call over both
seeds. The JAX scripts' flags and keys are read from their source."""
import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

from cdgvae_torch.tools import (cdm_seeds, dr_sweep, online_seeds, se_seeds,
                                tabular_seeds)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CUT = dict(cdm_seeds.CONFIG, epochs=1, n_samples=256, classifier_epochs=1)
PORT_FLAGS = {"device": "cuda", "init": "torch", "first_seed": 1,
              "eager": False}

# (tool, the JAX script, the name the script gives its summary dict, or
# the function whose returned dict is the record, the cut run's flags)
STUDIES = {
    "se_seeds": (se_seeds, "summary", ["--epochs", "1", "--n", "256"]),
    "online_seeds": (online_seeds, "out", []),
    "dr_sweep": (dr_sweep, "run_config", ["--lams", "40", "--repeats", "1"]),
    "tabular_seeds": (tabular_seeds, "all_results",
                      ["--datasets", "loan", "--epochs", "1"]),
}


def _jax_script(name: str, holder: str):
    """({flag: default}, summary keys) of ``scripts/<name>.py``: the keys
    of every dict assigned to ``holder`` or to ``holder[...]``, or returned
    by the function ``holder``; the keys a ``**`` spreads are left out."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    flags, keys = {}, set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw \
                else False  # store_true
            flags[node.args[0].value.lstrip("-")] = default
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if isinstance(target, ast.Subscript):
                target = target.value
            if (getattr(target, "id", "") == holder
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys if k is not None}
        if isinstance(node, ast.FunctionDef) and node.name == holder:
            ret = [n for n in ast.walk(node) if isinstance(n, ast.Return)]
            keys = {k.value for k in ret[-1].value.keys if k is not None}
    assert keys, f"no summary keys found in scripts/{name}.py"
    return flags, keys


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_study_has_the_jax_flags_and_writes_its_summary(name, tmp_path,
                                                        monkeypatch):
    tool, holder, cut_flags = STUDIES[name]
    flags, keys = _jax_script(name, holder)
    got = vars(tool.get_args([]))
    assert set(got) == set(flags) | set(PORT_FLAGS)
    for flag, default in {**flags, **PORT_FLAGS}.items():
        if flag != "out":  # each package writes under its own tree
            assert got[flag] == default, flag
    assert Path(got["out"]).name == f"{name}.json"
    assert Path(got["out"]).parent == Path(cdm_seeds.RESULTS)

    if hasattr(tool, "CONFIG"):  # the pendulum studies' protocol
        monkeypatch.setattr(tool, "CONFIG", dict(
            tool.CONFIG, epochs=1, n_samples=256, classifier_epochs=1,
            robustness_epochs=5))
    out = tmp_path / f"{name}.json"
    tool.main(["--seeds", "1", "--device", "cpu", "--out", str(out),
               *cut_flags])
    summary = json.loads(out.read_text())
    records = summary if name == "dr_sweep" else [summary]
    assert len(records) == 1
    if name == "tabular_seeds":  # the dataset's keys are nested under it
        records = [{**summary, **summary["loan"]}]
    for record in records:
        assert keys <= set(record)
        assert record["device"] == "cpu" and record["card"] is None
        assert record["init"] == "torch"
    if name == "se_seeds":
        assert summary["seeds"] == [1]
        (per_seed,) = summary["per_seed"]
        assert set(per_seed) == {"accuracy_100", "accuracy_all",
                                 "sample_efficiency"}
        assert all(0.0 <= v <= 1.0 for v in (per_seed["accuracy_100"],
                                             per_seed["accuracy_all"]))
    elif name == "tabular_seeds":
        _, row_keys = _jax_script(name, "out")
        (row,) = summary["loan"]["per_seed"]
        assert set(row) == row_keys and row["seed"] == 1
        assert summary["loader_branch"] == "synthetic-fallback"
        assert summary["loan"]["task"] == "regression"
        assert summary["loan"]["efficacy_rows"] == ["linear"]
        assert len(summary["loan"]["loss_curves"][0]) == 1
        assert row["shd_train"] >= 0 and row["shd_sample"] >= 0
    elif name == "online_seeds":
        upper = np.asarray(summary["upper_per_seed"])
        assert upper.shape == (1, 4, 4) and np.isfinite(upper).all()
        assert summary["protected_all_zero"] is True
        assert summary["protected_max"] == 0.0
        assert len(summary["loss_curves"][0]) == 1
    else:
        (r,) = records
        assert (r["beta"], r["lambda"], r["seed"]) == (0.1, 40.0, 1)
        assert len(r["bg_corr_per_latent"]) == 5
        assert all(0.0 <= r[k] <= 1.0
                   for k in ("avg_accuracy", "worst_group_accuracy"))
    for record in records:
        assert all(math.isfinite(v) for v in _numbers(record))


def _numbers(obj):
    if isinstance(obj, dict):
        return [v for x in obj.values() for v in _numbers(x)]
    if isinstance(obj, list):
        return [v for x in obj for v in _numbers(x)]
    return [obj] if isinstance(obj, float) else []


def test_cdm_seeds_from_the_jax_init(tmp_path, monkeypatch):
    monkeypatch.setattr(cdm_seeds, "CONFIG", CUT)
    out = tmp_path / "cdm.json"
    summary = cdm_seeds.main(["--seeds", "1", "--first_seed", "2", "--init",
                              "jax", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))
    assert summary["seeds"] == [2] and summary["init"] == "jax"
    upper, lower = np.asarray(summary["upper"]), np.asarray(summary["lower"])
    assert np.isfinite(upper).all() and np.isfinite(lower).all()
    for i, j in cdm_seeds.PROTECTED:
        assert upper[0, i, j] == 0.0 and lower[0, i, j] == 0.0
    with pytest.raises(ValueError, match="jax.random.normal"):
        cdm_seeds.main(["--seeds", "1", "--init", "jax", "--scm",
                        "nonlinear", "--device", "cpu", "--out",
                        str(tmp_path / "refused.json")])


def test_merge_summaries_equals_one_call(tmp_path, monkeypatch):
    monkeypatch.setattr(cdm_seeds, "CONFIG", CUT)
    base = ["--device", "cpu"]
    paths = [tmp_path / f"s{k}.json" for k in (1, 2)]
    for k, path in zip((1, 2), paths):
        cdm_seeds.main(base + ["--seeds", "1", "--first_seed", str(k),
                               "--out", str(path)])
    cdm_seeds.main(base + ["--seeds", "2", "--out",
                           str(tmp_path / "both.json")])
    merged = cdm_seeds.merge_summaries(paths, str(tmp_path / "merged.json"))
    both = json.loads((tmp_path / "both.json").read_text())
    assert json.loads((tmp_path / "merged.json").read_text()) == merged
    assert merged["seeds"] == both["seeds"] == [1, 2]
    for key in set(both) - {"train_seconds"}:
        assert merged[key] == both[key], key
    with pytest.raises(ValueError, match="repeats"):
        cdm_seeds.merge_summaries([paths[0], paths[0]])


def test_tabular_seeds_tvae_on_the_fixture_corpus_from_the_jax_init(tmp_path):
    out = tmp_path / "tvae.json"
    summary = tabular_seeds.main([
        "--tvae", "--datasets", "loan", "--seeds", "1", "--first_seed", "2",
        "--epochs", "1", "--init", "jax", "--fixture_corpus", "--data_dir",
        str(tmp_path / "corpus"), "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))
    assert summary["loader_branch"] == "real-csv" and summary["init"] == "jax"
    assert (tmp_path / "corpus" / "Bank_Personal_Loan_Modelling.csv").exists()
    (row,) = summary["loan"]["per_seed"]
    assert set(row) == {"seed", "train_s", "final_loss", "shd_sample",
                        "efficacy_synthetic"} and row["seed"] == 2
    assert all(math.isfinite(v) for v in _numbers(summary))


def test_tabular_merge_summaries_joins_seeds(tmp_path):
    def part(seeds, shd):
        rows = [{"seed": s, "train_s": 1.0, "final_loss": 2.0,
                 "shd_train": 1, "shd_sample": v, "efficacy_synthetic": v / 10}
                for s, v in zip(seeds, shd)]
        summary = {"loader_branch": "synthetic-fallback", "data_dir": "",
                   "adult": tabular_seeds.dataset_summary(
                       "classification", 0.8, rows, [[3.0]] * len(rows),
                       ["logistic"]),
                   "init": "torch", "device": "cpu", "card": None}
        path = tmp_path / f"p{seeds[0]}.json"
        path.write_text(json.dumps(summary))
        return str(path)

    merged = tabular_seeds.merge_summaries([part([1, 2], [2, 4]),
                                            part([3], [6])])
    assert [r["seed"] for r in merged["adult"]["per_seed"]] == [1, 2, 3]
    assert merged["adult"]["shd_sample_mean"] == 4.0
    assert merged["adult"]["efficacy_synthetic_mean"] == 0.4
    assert len(merged["adult"]["loss_curves"]) == 3
    assert merged["card"] is None and "loan" not in merged
    with pytest.raises(ValueError, match="repeats"):
        tabular_seeds.merge_summaries([part([1], [2]), part([1], [3])])
