"""``cdgvae_torch/tools/cdm_seeds.py`` against the JAX package's
``scripts/cdm_seeds.py``: the same flags and defaults (plus ``--device``,
``--init``, ``--first_seed`` and ``--eager``),
and a run cut to 1 epoch on 256 samples on the CPU that writes every key
of the JAX script's summary, with the protected CDM cells exactly 0.0 for
the CDG-VAE (supervised and semi) and finite matrices for InfoMax. The
JAX script's flags and summary keys are read from its source."""
import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

from cdgvae_torch.tools import cdm_seeds

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "cdm_seeds.py"
CUT = dict(cdm_seeds.CONFIG, epochs=1, n_samples=256, classifier_epochs=1)


def _jax_script():
    """({flag: default}, summary keys) of the JAX script."""
    tree = ast.parse(SCRIPT.read_text())
    flags, keys = {}, set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw \
                else False  # store_true
            flags[node.args[0].value.lstrip("-")] = default
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "summary"):
            keys = {k.value for k in node.value.keys}
    return flags, keys


def test_cli_has_the_jax_scripts_flags_and_defaults():
    flags, _ = _jax_script()
    assert set(flags) == {"seeds", "scm", "semi", "model", "gamma",
                          "free_bits", "out"}
    got = vars(cdm_seeds.get_args([]))
    assert set(got) == set(flags) | {"device", "init", "first_seed",
                                     "eager"}
    assert got["eager"] is False
    assert got["device"] == "cuda"
    assert got["init"] == "torch" and got["first_seed"] == 1
    for name, default in flags.items():
        if name != "out":  # each package writes under its own tree
            assert got[name] == default, name
    assert Path(got["out"]).name == "cdm_seeds.json"
    assert Path(cdm_seeds.get_args(["--model", "InfoMax"]).out).name \
        == "cdm_seeds_infomax.json"
    with pytest.raises(SystemExit):
        cdm_seeds.get_args(["--semi", "--model", "VAE"])


@pytest.mark.parametrize("case", ["CDGVAE", "semi", "InfoMax"])
def test_cut_run_writes_the_jax_summary(case, tmp_path, monkeypatch):
    monkeypatch.setattr(cdm_seeds, "CONFIG", CUT)
    out = tmp_path / "cdm.json"
    args = ["--seeds", "1", "--device", "cpu", "--out", str(out)]
    args += ["--semi"] if case == "semi" else \
        ["--model", "InfoMax"] if case == "InfoMax" else []
    cdm_seeds.main(args)
    summary = json.loads(out.read_text())
    _, keys = _jax_script()
    assert keys <= set(summary)
    assert summary["seeds"] == [1] and summary["device"] == "cpu"
    upper, lower = np.asarray(summary["upper"]), np.asarray(summary["lower"])
    assert upper.shape == lower.shape == (1, 4, 4)
    assert np.isfinite(upper).all() and np.isfinite(lower).all()
    curve = summary["loss_curves"][0]
    assert len(curve) == 1 and math.isfinite(curve[0])
    if case != "InfoMax":  # the masked GAM decoder's structural zeros
        for i, j in cdm_seeds.PROTECTED:
            assert upper[0, i, j] == 0.0 and lower[0, i, j] == 0.0
        assert summary["protected_max_abs"] == 0.0
