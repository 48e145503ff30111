"""``--dp`` on the port's training CLIs, over gloo ranks on the CPU, and
mesh serving.

Each CLI trains 2 epochs with ``--dp 2 --device cpu`` at small sizes
(16 px, batch 8; tabular and CelebA at cut sizes): the losses are finite
and fall, rank 0 alone prints the epoch lines and writes the metric log
and checkpoint, and a ``--resume`` run at world 2 continues bit for bit.
A rank that fails fails the CLI. ``resolve_mesh`` follows the reference's
rules, ``main_classifier`` takes ``--dp`` and ignores it, and
``LoadedModel(mesh=make_mesh(2, "cpu"))`` answers as plain serving does
(padded to a multiple of the replicas; CelebA whole on the first device).
"""
import contextlib
import io
import json
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from cdgvae_torch.api import LoadedModel
from cdgvae_torch.cli import (celeba_main, common, dr_main, main,
                              main_classifier, main_semi, tabular_main,
                              tabular_main_tvae)
from cdgvae_torch.parallel import Mesh, make_mesh, shard_rows, split_batch
from cdgvae_torch.utils.checkpoint import load_checkpoint

S = ["--device", "cpu", "--image_size", "16", "--n_samples", "96",
     "--batch_size", "8", "--epochs", "2"]
DP = ["--dp", "2"]
RUNS = {
    "main": (main, S, "model_CDGVAE_linear"),
    "online": (main, S + ["--online"], "model_CDGVAE_linear"),
    "eager": (main, S + ["--eager"], "model_CDGVAE_linear"),
    "infomax": (main, S + ["--model", "InfoMax"], "model_InfoMax_linear"),
    "semi": (main_semi, S + ["--labeled_ratio", "0.3", "--batch_sizeL",
                             "4"], "model_CDGVAEsemi_nonlinear"),
    "dr": (dr_main, S, "model_DR_CDGVAE_linear"),
    "tabular": (tabular_main, ["--device", "cpu", "--epochs", "2"],
                "tabular_CDGVAE_loan"),
    "tabular infomax": (tabular_main, ["--device", "cpu", "--epochs", "2",
                                       "--model", "InfoMax"],
                        "tabular_InfoMax_loan"),
    "tvae": (tabular_main_tvae, ["--device", "cpu", "--epochs", "2"],
             "tabular_TVAE_loan"),
    "celeba": (celeba_main, ["--device", "cpu", "--img_size", "32",
                             "--conv_dim", "4", "--batch_size", "8",
                             "--epochs", "2", "--ckpt_every", "0"],
               "celeba_CDGVAE_linear"),
}


def _run_captured(cli, args, out: Path) -> str:
    """``cli.main(args)`` in this process; returns what it and its spawned
    ranks printed (the ranks write to file descriptor 1, kept in
    ``out``)."""
    sys.stdout.flush()
    saved = os.dup(1)
    parent = io.StringIO()
    with open(out, "w") as f:
        os.dup2(f.fileno(), 1)
        try:
            with contextlib.redirect_stdout(parent):
                cli.main(args)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
    return parent.getvalue() + out.read_text()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: assets dir} of every run in RUNS, and of a run cut at epoch
    1 and resumed to 2; the runs after the first go three at a time."""
    root = tmp_path_factory.mktemp("dp")
    done = {name: root / name.replace(" ", "_") for name in RUNS}
    done["resumed"] = root / "resumed"

    def run(name):
        if name == "resumed":
            d = done["resumed"]
            assert S[-2:] == ["--epochs", "2"]
            main.main(S[:-1] + ["1"] + DP + ["--assets_dir", str(d)])
            main.main(S + DP + ["--assets_dir", str(d), "--resume",
                                str(d / "model_CDGVAE_linear")])
        else:
            cli, args, _ = RUNS[name]
            cli.main(args + DP + ["--assets_dir", str(done[name])])

    first, *rest = list(RUNS) + ["resumed"]
    cli, args, _ = RUNS[first]
    said = _run_captured(cli, args + DP + ["--assets_dir", str(done[first])],
                         root / "main.out")
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(run, rest))
    return done, said


def _records(d: Path) -> list:
    with open(d / "metrics.jsonl") as f:
        return [json.loads(ln) for ln in f]


def test_dp_cli_prints_from_rank_0_alone(runs):
    _, said = runs
    assert said.count("[dp] training on 2 ranks (gloo)") == 1
    lines = [ln for ln in said.splitlines() if ln.startswith("[epoch")]
    assert [ln[:11] for ln in lines] == ["[epoch 001]", "[epoch 002]"]
    assert said.count("checkpoint saved to") == 1


@pytest.mark.parametrize("name", list(RUNS))
def test_dp_cli_trains_with_falling_losses(runs, name):
    d = runs[0][name]
    records = _records(d)
    assert [r["step"] for r in records] == [0, 1]  # rank 0's alone
    losses = [r["loss"] for r in records]
    assert all(math.isfinite(v) for v in losses)
    assert losses[1] < losses[0], losses
    ck = d / RUNS[name][2]
    assert (ck / "state.pkl").is_file()
    assert load_checkpoint(str(ck))["config"]["dp"] == 2


def test_dp_resume_continues_bit_for_bit(runs):
    d = runs[0]["resumed"]
    assert [r["step"] for r in _records(d)] == [0, 1]
    got = load_checkpoint(str(d / "model_CDGVAE_linear"))
    want = load_checkpoint(str(runs[0]["main"] / "model_CDGVAE_linear"))
    assert got["step"] == want["step"] == 2

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}{i}.")
        elif hasattr(tree, "_asdict"):
            yield from leaves(tree._asdict(), prefix)
        else:
            yield prefix, np.asarray(tree)

    for tree in ("params", "opt_state"):
        a, b = dict(leaves(got[tree])), dict(leaves(want[tree]))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_failing_rank_fails_the_cli(tmp_path):
    with pytest.raises(Exception, match="no_such_checkpoint"):
        main.main(S + DP + ["--assets_dir", str(tmp_path), "--resume",
                            str(tmp_path / "no_such_checkpoint")])
    assert not (tmp_path / "model_CDGVAE_linear").exists()


def test_main_classifier_takes_dp_and_ignores_it(tmp_path, capsys):
    main_classifier.main(S[:-2] + ["--epochs", "1", "--dp", "2",
                                   "--assets_dir", str(tmp_path)])
    said = capsys.readouterr().out
    assert "[dp]" not in said and "[epoch 001]" in said
    assert (tmp_path / "CDMClassifier" / "state.pkl").is_file()


@pytest.mark.parametrize("dp,device,extra,want", [
    (1, "cpu", (), None),
    (0, "cpu", (), None),           # one visible device on the CPU
    (2, "cpu", (), 2),
    (4, "cpu", (4,), 4),
    (3, "cpu", (), "batch_size 8 not divisible by dp=3"),
    (2, "cpu", (3,), "extra batch size 3 not divisible by dp=2"),
    (0, "cuda", (), "visible"),
    (2, "cuda", (), "visible"),
])
def test_resolve_mesh_follows_the_reference(dp, device, extra, want):
    config = {"dp": dp, "device": device, "batch_size": 8}
    n_gpu = torch.cuda.device_count()
    if device == "cuda" and want == "visible":
        if dp == 0:
            want = n_gpu if n_gpu > 1 and 8 % n_gpu == 0 else None
        elif n_gpu >= dp:
            want = dp
        else:
            with pytest.raises(RuntimeError, match=f"{dp}-device mesh but "
                               f"only {n_gpu} CUDA devices"):
                common.resolve_mesh(config, extra)
            return
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            common.resolve_mesh(config, extra)
    else:
        assert common.resolve_mesh(config, extra) == want


def test_shard_rows_takes_contiguous_blocks(capsys):
    x = torch.arange(11)
    blocks = [shard_rows(Mesh(size=3, rank=r), x)[0] for r in range(3)]
    assert [b.tolist() for b in blocks] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    assert "[dp] dropping 2 of 11 rows" in capsys.readouterr().out
    with pytest.raises(ValueError, match="smaller than the device count"):
        shard_rows(Mesh(size=4), x[:3])
    assert split_batch(8, Mesh(size=4)) == 2
    with pytest.raises(ValueError, match="batchL 6 not divisible"):
        split_batch(6, Mesh(size=4), name="batchL")


@pytest.mark.parametrize("name", ["main", "tabular infomax", "tvae",
                                  "celeba"])
def test_mesh_serving_equals_plain_serving(runs, name):
    ck = runs[0][name] / RUNS[name][2]
    plain = LoadedModel.load(str(ck), device="cpu")
    meshed = LoadedModel.load(str(ck), mesh=make_mesh(2, "cpu"))
    assert len(meshed._replicas) == (1 if name == "celeba" else 2)
    rng = np.random.default_rng(0)
    if name == "celeba":
        x = rng.uniform(0, 1, (5, 32, 32, 8)).astype(np.float32)
    elif name == "main":
        x = rng.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    else:  # a tabular model's encoded columns
        x = rng.normal(size=(5, plain.config["input_dim"])).astype(
            np.float32)
    calls = {"encode": lambda m: m.encode(x),
             "reconstruct": lambda m: m.reconstruct(x),
             "counterfactual": lambda m: m.counterfactual(x, 1, 0.3)}
    if name != "celeba":
        eps = rng.normal(size=(5, plain.model.node)).astype(np.float32)
        calls["generate"] = lambda m: m.generate(eps)
    for what, call in calls.items():
        # the TVAE's inverse draws its noise from numpy's global generator
        np.random.seed(0)
        got = call(meshed)
        np.random.seed(0)
        want = call(plain)
        got = np.asarray(getattr(got, "values", got), np.float64)
        want = np.asarray(getattr(want, "values", want), np.float64)
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=what)
