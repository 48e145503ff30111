"""``cdgvae_torch/tools/celeba_arms.py`` against the JAX script
``scripts/celeba_arms.py``, on the CPU:

- the flags (read from the script's source) and their defaults are the
  script's, but ``--retry_wait`` and ``--workdir`` (the card's, in the
  checkout), plus the port's ``--device`` and ``--out``;
  ``ARM_DEFAULTS`` and ``arm_paths`` are the script's;
- ``_arm_argv`` gives the script's argv for the same arm, but for the
  port's ``--device`` in place of the script's ``--platform``;
- the markers, the retry and the resume, at a tiny size (three arms: 32
  px, conv_dim 8, 16 faces, 1 or 2 epochs) through a worker that exits
  nonzero right after arm ``_b``'s epoch-1 checkpoint and, on its
  second attempt, right after arm ``_c``'s final checkpoint: the retries
  skip the finished arm ``_a``, resume ``_b`` from its checkpoint, and
  write ``_c``'s ``recovered`` marker without training it again; then
  ``--eval_only`` scores every arm with ``celeba_study``'s evaluation.
"""
import ast
import json
import sys
from pathlib import Path

import pytest
import torch

from cdgvae_torch.tools import celeba_arms
from cdgvae_torch.tools import celeba_study
from cdgvae_torch.utils.checkpoint import load_checkpoint
from scripts import celeba_arms as jax_arms

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "celeba_arms.py"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and these many small CPU ops on every core of every worker
    oversubscribe it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_flags() -> dict:
    flags = {}
    for node in ast.walk(ast.parse(SCRIPT.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw \
                else (None if "required" in kw else False)
            flags[node.args[0].value.lstrip("-")] = default
    return flags


def test_flags_and_arm_defaults_are_the_scripts():
    flags = _jax_flags()
    got = vars(celeba_arms.get_args(["--arms", "[]"]))
    assert set(got) == set(flags) | {"device", "out", "corpus"}
    for flag, default in flags.items():
        if flag in ("arms", "workdir", "retry_wait"):
            continue
        assert got[flag] == default, flag
    assert got["retry_wait"] == 5.0 and got["device"] == "cuda"
    assert Path(got["workdir"]) == Path(celeba_arms.REPO) / "build" / \
        "celeba_arms"
    assert Path(got["out"]).name == "celeba_arms.json"
    assert Path(celeba_arms.get_args(["--arms", "[]", "--summary_tag",
                                      "_x"]).out).name == "celeba_arms_x.json"
    assert celeba_arms.ARM_DEFAULTS == jax_arms.ARM_DEFAULTS
    arm = {"tag": "_t"}
    assert celeba_arms.arm_paths("/w", arm) == jax_arms.arm_paths("/w", arm)
    assert celeba_arms.get_args(["--arms", "[]", "--platform",
                                 "gpu"]).device == "cuda"
    with pytest.raises(SystemExit):
        celeba_arms.get_args(["--arms", '[{"seed": 2}]'])


ARMS = [{"tag": "_t"},
        {"tag": "_u", "lam": 50.0, "align_warmup": 300, "epochs": 400,
         "bf16": True, "train_trunk": True, "torch_weights": "/w.pt",
         "extra_args": ["--async_ckpt", "False"]},
        {"tag": "_v", "seed": 4, "conv_dim": 8, "chunk": 5,
         "ckpt_every": 1}]


@pytest.mark.parametrize("arm", ARMS, ids=[a["tag"] for a in ARMS])
@pytest.mark.parametrize("resume", ["", "/ck"])
def test_argv_is_the_scripts_but_for_the_device(arm, resume):
    got = celeba_arms._arm_argv(arm, "/c", "/a", 64, "cuda", resume)
    i = got.index("--device")
    assert got[i + 1] == "cuda"
    assert got[:i] + got[i + 2:] == jax_arms._arm_argv(
        arm, "/c", "/a", 64, "", resume)
    with_platform = jax_arms._arm_argv(arm, "/c", "/a", 64, "gpu", resume)
    assert with_platform.index("--platform") == i


# the worker of every attempt, which exits 3 right after the checkpoints
# named in CRASHES (once each, recorded in the state file argv[1])
WRAPPER = """
import json, os, sys
from cdgvae_torch.cli import celeba_main
from cdgvae_torch.tools import celeba_arms
state = sys.argv[1]
real = celeba_main.save_checkpoint
def save(path, *args, step, **kw):
    real(path, *args, step=step, **kw)
    done = json.load(open(state)) if os.path.exists(state) else []
    key = f"{os.path.basename(os.path.dirname(path))}@{step}"
    if key in %r and key not in done:
        json.dump(done + [key], open(state, "w"))
        os._exit(3)
celeba_main.save_checkpoint = save
celeba_arms.main(sys.argv[2:])
"""
CRASHES = ["assets_b@1", "assets_c@1"]


def test_retry_skips_done_arms_resumes_and_recovers(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the workers' threads
    crashes = tmp_path / "crashes.json"
    real = celeba_arms.worker_command
    monkeypatch.setattr(celeba_arms, "worker_command", lambda args, arms: [
        sys.executable, "-c", WRAPPER % (CRASHES,), str(crashes),
        *real(args, arms)[3:]])
    arms = [{"tag": "_a", "epochs": 1, "conv_dim": 8},
            {"tag": "_b", "epochs": 2, "ckpt_every": 1, "conv_dim": 8,
             "seed": 2},
            {"tag": "_c", "epochs": 1, "conv_dim": 8, "seed": 3}]
    work, out = tmp_path / "work", tmp_path / "results" / "arms.json"
    common = ["--arms", json.dumps(arms), "--n_train", "16", "--n_test",
              "4", "--img_size", "32", "--workdir", str(work), "--device",
              "cpu", "--retry_wait", "0", "--out", str(out)]
    summary = celeba_arms.main(common + ["--no_eval"])
    assert json.loads(crashes.read_text()) == CRASHES
    assert capsys.readouterr().out.count("[parent] worker attempt") == 2
    assert json.loads(out.read_text()) == summary
    assert summary["arms"] == ["_a", "_b", "_c"]
    assert summary["device"] == "cpu" and summary["card"] is None
    marks = {m["tag"]: m for m in summary["per_arm"]}
    assert marks["_a"]["resumed"] is False and marks["_a"]["startup_s"] >= 0
    # startup is the first arm's of the list, as in the script
    assert marks["_b"]["resumed"] is True and marks["_b"]["startup_s"] == 0
    assert marks["_b"]["wall_s"] > 0
    assert marks["_a"]["allocated_before"] is None  # no card
    assert marks["_c"] == {"tag": "_c", "wall_s": None, "recovered": True}
    for tag, epochs in (("_a", 1), ("_b", 2), ("_c", 1)):
        _, ckpt, _ = celeba_arms.arm_paths(str(work), {"tag": tag})
        assert int(load_checkpoint(ckpt)["step"]) == epochs
    assert not (out.parent / "celeba_study_a.json").exists()

    summary = celeba_arms.main(common + ["--eval_only"])
    assert [m["tag"] for m in summary["per_arm"]] == ["_a", "_b", "_c"]
    for tag, seed in (("_a", 1), ("_b", 2), ("_c", 3)):
        study = json.loads((out.parent / f"celeba_study{tag}.json")
                           .read_text())
        (row,) = study["per_seed"]
        assert row["seed"] == seed and study["protocol"]["seeds"] == [seed]
        assert study["do_leakage_max"] == 0.0
        assert (out.parent / f"celeba_do{tag}.png").is_file()
    assert celeba_study.REPO == celeba_arms.REPO
