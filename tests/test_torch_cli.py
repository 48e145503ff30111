"""The port's pendulum CLI on the CPU: artifacts, the metric log's record
shape against the JAX package's, a resumed run against the uninterrupted
one (bit for bit), the resume guard, the eager protocol, --online,
InfoMax and --labeled_ratio, and the flags that are refused (the
data-parallel mesh, a backend the port does not run on, a --platform that
contradicts --device). 16 px, 96 DGP samples (a 72-image train split),
batch 32.
"""
import json
import os
import pickle

import numpy as np
import pytest
import jax.numpy as jnp

from cdgvae_tpu.train import loop as jloop
from cdgvae_tpu.train import steps as jsteps
from cdgvae_tpu.utils.logging import MetricLogger as JMetricLogger
from cdgvae_torch.cli import dr_main, main, main_semi
from cdgvae_torch.utils.checkpoint import load_checkpoint

SMALL = ["--device", "cpu", "--image_size", "16", "--n_samples", "96",
         "--batch_size", "32"]
CKPT = "model_CDGVAE_linear"


def _main(out, *args):
    return main.main(SMALL + ["--assets_dir", str(out), *args])


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                              "big")


@pytest.mark.parametrize("mode", ["dataset", "online"])
def test_cli_writes_every_artifact(tmp_path, capsys, mode):
    _main(tmp_path, "--epochs", "2", *(["--online"] if mode == "online"
                                        else []))
    out = capsys.readouterr().out
    assert f"checkpoint saved to {tmp_path / CKPT}" in out
    ck = load_checkpoint(str(tmp_path / CKPT))
    assert ck["step"] == 2 and ck["config"]["online"] == (mode == "online")
    assert ck["config"]["spurious"] is False
    # 72 train images at batch 32: 2 steps per epoch (the remainder is
    # dropped, or online 72 // 32 steps per epoch-equivalent)
    assert int(ck["opt_state"][0].count) == 4
    records = _records(tmp_path)
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)
    for name in ("recon.png", "tmp_image_0.png"):
        # three panels of 16 px to a row, 2 px apart (utils/viz.py)
        assert _png_size(tmp_path / name) == (3 * 18 + 2, 3 * 18 + 2)


def test_metric_log_keys_match_jax(tmp_path):
    """The JAX CLI logs ``Averager.result()`` of its step metrics through
    its MetricLogger; the port's record has the same keys in the same
    order."""
    _main(tmp_path / "port", "--epochs", "1")
    node = 4
    avg = jloop.Averager()
    avg.add(jsteps._metrics(jnp.float32(1.0), jnp.float32(1.0),
                            jnp.float32(1.0), jnp.float32(1.0),
                            jnp.zeros((2, node)), node))
    logger = JMetricLogger(logdir=str(tmp_path / "jax"))
    logger.log(avg.result(), step=0)
    logger.finish()
    assert list(_records(tmp_path / "port")[0]) == \
        list(_records(tmp_path / "jax")[0])


def _state(out, ckpt=CKPT):
    with open(os.path.join(out, ckpt, "state.pkl"), "rb") as f:
        raw = f.read()
    return raw, load_checkpoint(os.path.join(out, ckpt))


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


SEMI = ["--labeled_ratio", "0.3", "--batch_sizeL", "8"]
# mode: (entry point, flags, checkpoint directory)
RESUMABLE = {
    "dataset": (main, [], CKPT),
    "online": (main, ["--online"], CKPT),
    "semi": (main_semi, SEMI, "model_CDGVAEsemi_nonlinear"),
    "semi online": (main_semi, SEMI + ["--online"],
                    "model_CDGVAEsemi_nonlinear"),
    "InfoMax": (main, ["--model", "InfoMax"], "model_InfoMax_linear"),
    "DR": (dr_main, [], "model_DR_CDGVAE_linear"),
    "DR online": (dr_main, ["--online"], "model_DR_CDGVAE_linear"),
}


@pytest.mark.parametrize("mode", list(RESUMABLE))
def test_resume_reproduces_the_uninterrupted_run(tmp_path, capsys, mode):
    cli, extra, ckpt = RESUMABLE[mode]

    def run(out, *args):
        cli.main(SMALL + ["--assets_dir", str(out), *extra, *args])

    run(tmp_path / "a", "--epochs", "2")
    run(tmp_path / "a", "--epochs", "4", "--resume",
        str(tmp_path / "a" / ckpt))
    assert f"resumed from {tmp_path / 'a' / ckpt} at epoch 2" in \
        capsys.readouterr().out
    run(tmp_path / "b", "--epochs", "4")
    raw_a, ck_a = _state(tmp_path / "a", ckpt)
    raw_b, ck_b = _state(tmp_path / "b", ckpt)
    assert ck_a["step"] == ck_b["step"] == 4
    _assert_trees_equal(ck_a["params"], ck_b["params"])
    _assert_trees_equal(ck_a["opt_state"], ck_b["opt_state"])
    assert (ck_a["extras"] is None) == (mode != "InfoMax")
    if mode == "InfoMax":
        _assert_trees_equal(ck_a["extras"], ck_b["extras"])
    assert raw_a == raw_b
    strip = [{k: v for k, v in r.items() if k != "time"}
             for r in _records(tmp_path / "a")]
    assert strip == [{k: v for k, v in r.items() if k != "time"}
                     for r in _records(tmp_path / "b")]


def test_resume_at_or_past_epochs_is_refused(tmp_path):
    _main(tmp_path, "--epochs", "1")
    for epochs in ("1", "0"):
        with pytest.raises(ValueError, match="already >= --epochs"):
            _main(tmp_path, "--epochs", epochs, "--resume",
                  str(tmp_path / CKPT))


def test_eager_keeps_the_partial_batch(tmp_path):
    _main(tmp_path, "--epochs", "1", "--eager")
    ck = load_checkpoint(str(tmp_path / CKPT))
    # 72 images at batch 32: 32, 32 and the partial 8
    assert int(ck["opt_state"][0].count) == 3
    assert np.isfinite(_records(tmp_path)[0]["loss"])


def test_online_loss_falls(tmp_path):
    _main(tmp_path, "--epochs", "3", "--online", "--batch_size", "24")
    losses = [r["loss"] for r in _records(tmp_path)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("args,why", [
    (["--model", "InfoMax", "--free_bits", "0.5"], "--free_bits"),
    (["--online", "--labeled_ratio", "0.5"], "--online supports"),
    (["--online", "--data_dir", "pngs"], "--online supports"),
    # --platform and --profile are ported (tests/test_torch_profiling.py);
    # a backend the port does not run on, and a --platform that
    # contradicts the --device cpu of SMALL, are refused
    pytest.param(["--platform", "tpu"], "--platform tpu is not supported",
                 id="args3-item 15"),
    # --dp is ported (tests/test_torch_parallel_cli.py): a rank count that
    # does not divide the batch is refused before any rank starts
    pytest.param(["--dp", "3", "--batch_size", "8"],
                 "batch_size 8 not divisible by dp=3", id="args4-item 14"),
    pytest.param(["--profile", "trace", "--platform", "gpu"],
                 "--platform gpu contradicts --device cpu",
                 id="args5-item 15"),
    (["--online", "--eager"], "--online supports"),
])
def test_unported_flags_are_refused(tmp_path, capsys, args, why):
    with pytest.raises(SystemExit) as exc:
        _main(tmp_path, "--epochs", "1", *args)
    said = f"{exc.value.code} {capsys.readouterr().err}"
    assert why in said
    assert not os.path.exists(tmp_path / CKPT)


@pytest.mark.parametrize("args", [["--model", "InfoMax"],
                                  ["--labeled_ratio", "0.5"]])
def test_infomax_and_labeled_ratio_train(tmp_path, args):
    """Flags the first slices refused: InfoMax trains the VAE with its
    discriminator, and ``--labeled_ratio`` cuts the train split as the
    JAX CLI does."""
    _main(tmp_path, "--epochs", "1", *args)
    infomax = args[1] == "InfoMax"
    ck = load_checkpoint(str(tmp_path / ("model_InfoMax_linear" if infomax
                                         else CKPT)))
    assert ck["config"][args[0][2:]] == (args[1] if infomax else 0.5)
    record = _records(tmp_path)[0]
    assert np.isfinite(record["loss"])
    assert ("MutualInfo" in record) == infomax
    if infomax:
        # 72 images at batch 32: 2 steps for both Adams
        assert int(ck["opt_state"][0].count) == 2
        assert int(ck["extras"]["opt_state_d"][0].count) == 2
        assert set(ck["extras"]["d_params"]) == {"net"}
    else:
        # the first half of the 72-image split: 36 images, 1 step
        assert int(ck["opt_state"][0].count) == 1
        assert ck["extras"] is None


def test_state_pickle_names_optax_classes(tmp_path):
    """What the JAX package's unpickler looks up."""
    _main(tmp_path, "--epochs", "1")
    with open(tmp_path / CKPT / "state.pkl", "rb") as f:
        raw = f.read()
    import pickletools
    names = {arg for op, arg, _ in pickletools.genops(raw)
             if op.name == "SHORT_BINUNICODE"}
    assert {"optax._src.transform", "ScaleByAdamState", "optax._src.base",
            "EmptyState"} <= names
    assert "cdgvae_torch.utils.interop" not in names
    assert isinstance(pickle.loads(raw)["params"], dict)


def test_cli_chain_semi_infomax_classifier_metric_inference(tmp_path,
                                                            capsys):
    """The port's eval chain on what its trainers wrote (16 px, 200 DGP
    samples): the CDM structural zeros read exactly 0.0 for the supervised
    and the semi-supervised CDG-VAE, the two packages' metric CLIs agree
    across checkpoints each other wrote, and the inference CLI writes its
    figures."""
    import pandas as pd
    from cdgvae_tpu.cli import main_classifier as jax_main_classifier
    from cdgvae_tpu.cli import metric as jmetric
    from cdgvae_torch.api import LoadedModel
    from cdgvae_torch.cli import inference, main_classifier, metric

    small = ["--device", "cpu", "--image_size", "16", "--n_samples", "200",
             "--batch_size", "32", "--epochs", "1"]
    main.main(small + ["--assets_dir", str(tmp_path)])
    main_semi.main(small + SEMI + ["--eager", "--assets_dir", str(tmp_path)])
    main.main(small + ["--model", "InfoMax", "--assets_dir", str(tmp_path)])
    main_classifier.main(small + ["--assets_dir", str(tmp_path / "clf")])
    clf = str(tmp_path / "clf" / "CDMClassifier")
    assert load_checkpoint(clf)["config"]["image_size"] == 16
    # the semi model is scored with the JAX package's classifier, by both
    # packages' metric CLIs: each reads a checkpoint the other wrote
    jax_main_classifier.main(small[2:] + ["--assets_dir",
                                          str(tmp_path / "jclf")])
    jclf = str(tmp_path / "jclf" / "CDMClassifier")

    cdm = tmp_path / "cdm"
    for name in ("CDGVAE_linear", "CDGVAEsemi_nonlinear", "InfoMax_linear"):
        ckpt = str(tmp_path / f"model_{name}")
        clf_used = jclf if name == "CDGVAEsemi_nonlinear" else clf
        lower, upper = metric.main(["--device", "cpu", "--checkpoint", ckpt,
                                    "--classifier_checkpoint", clf_used,
                                    "--assets_dir", str(cdm)])
        assert np.isfinite(lower).all() and np.isfinite(upper).all()
        csv = pd.read_csv(cdm / f"upper_{name}_0.csv", index_col=0)
        assert list(csv.columns) == ["light", "angle", "length", "position"]
        assert (cdm / f"lower_{name}_0.png").is_file()
        if name != "InfoMax_linear":
            for s, c in [(2, 0), (2, 1), (3, 0), (3, 1), (0, 1), (1, 0)]:
                assert lower[s, c] == 0.0 and upper[s, c] == 0.0, (s, c)
                assert csv.iloc[s, c] == 0.0
        if name == "CDGVAEsemi_nonlinear":
            want = jmetric.main(["--checkpoint", ckpt,
                                 "--classifier_checkpoint", jclf,
                                 "--assets_dir", str(tmp_path / "jcdm")])
            for g, w in zip((lower, upper), want):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)

    ckpt = str(tmp_path / "model_CDGVAEsemi_nonlinear")
    grid = inference.main(["--device", "cpu", "--checkpoint", ckpt,
                           "--assets_dir", str(tmp_path / "inf")])
    assert grid.shape == (4, 7, 16, 16, 3) and np.isfinite(grid).all()
    assert sorted(os.listdir(tmp_path / "inf")) == sorted(
        ["latent_maxmin_orig.png", "latent_maxmin.png",
         "posterior_variance.png", "crossentropy.png",
         "original_and_recon.png", "gam.png", "do.png"])
    x = np.zeros((2, 16, 16, 3), np.float32)
    assert LoadedModel.load(ckpt, device="cpu").reconstruct(x).shape == \
        x.shape
    # the reference's --platform cpu is the port's --device cpu
    got = metric.main(["--checkpoint", ckpt, "--classifier_checkpoint", clf,
                       "--platform", "cpu", "--assets_dir",
                       str(tmp_path / "cdm_platform")])
    want = metric.main(["--device", "cpu", "--checkpoint", ckpt,
                        "--classifier_checkpoint", clf, "--assets_dir",
                        str(tmp_path / "cdm_device")])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(SystemExit):
        metric.main(["--checkpoint", ckpt, "--classifier_checkpoint", clf,
                     "--platform", "tpu"])
    assert "--platform tpu is not supported" in capsys.readouterr().err


def _read_numbers(path):
    """The numbers after the colons of a downstream eval's text file."""
    with open(path) as f:
        return {line.split(":")[0]: float(line.split(":")[1])
                for line in f}


def test_dr_cli_chain(tmp_path, capsys):
    """The DR family's CLIs on what they trained (16 px, 200 DGP samples):
    dr_main (and InfoMax) and dr_main_semi --online write their DR
    checkpoints, dr_robustness and inference read one, metric refuses it;
    then main -> sample_efficiency and toy_dr."""
    from cdgvae_torch.cli import (dr_main_semi, dr_robustness, inference,
                                  metric, sample_efficiency, toy_dr)

    small = ["--device", "cpu", "--image_size", "16", "--n_samples", "200",
             "--batch_size", "32", "--epochs", "1", "--assets_dir",
             str(tmp_path)]
    dr_main.main(small)
    dr_main.main(small + ["--model", "InfoMax"])
    dr_main_semi.main(small + SEMI + ["--online"])
    ckpt = str(tmp_path / "model_DR_CDGVAE_linear")
    cfg = load_checkpoint(ckpt)["config"]
    assert cfg["spurious"] is True and (cfg["node"], cfg["lambda"]) == (5, 20)
    ex = load_checkpoint(str(tmp_path / "model_DR_InfoMax_linear"))["extras"]
    assert set(ex) == {"d_params", "opt_state_d"} and set(
        ex["d_params"]) == {"net"}
    semi = load_checkpoint(str(tmp_path / "model_DR_CDGVAEsemi_nonlinear"))
    assert (semi["config"]["node"], semi["config"]["lambda"]) == (5, 5)
    assert semi["config"]["spurious"] is True
    records = _records(tmp_path)
    assert len(records) == 3 and all(np.isfinite(r["loss"]) for r in records)
    assert not (tmp_path / "recon.png").exists()  # as the reference's DR

    out = dr_robustness.main(["--device", "cpu", "--checkpoint", ckpt,
                              "--repeats", "1", "--epochs", "5",
                              "--assets_dir", str(tmp_path / "rob")])
    said = _read_numbers(tmp_path / "rob" / "CDGVAE_linear_0.txt")
    assert list(said) == ["average accuracy", "worst-group accuracy"]
    assert 0 <= out["worst_group_accuracy"] <= out["avg_accuracy"] <= 1
    grid = inference.main(["--device", "cpu", "--checkpoint", ckpt,
                           "--assets_dir", str(tmp_path / "inf")])
    assert grid.shape == (5, 7, 16, 16, 3) and np.isfinite(grid).all()
    with pytest.raises(SystemExit, match="DR checkpoint"):
        metric.main(["--device", "cpu", "--checkpoint", ckpt,
                     "--classifier_checkpoint", ckpt])

    main.main(small[:-1] + [str(tmp_path / "p")])
    with pytest.raises(SystemExit, match="not a DR checkpoint"):
        dr_robustness.main(["--device", "cpu", "--checkpoint",
                            str(tmp_path / "p" / "model_CDGVAE_linear")])
    out = sample_efficiency.main([
        "--device", "cpu", "--checkpoint",
        str(tmp_path / "p" / "model_CDGVAE_linear"), "--repeats", "1",
        "--assets_dir", str(tmp_path / "se")])
    said = _read_numbers(tmp_path / "se" / "CDGVAE_linear_0.txt")
    assert list(said) == ["100 samples accuracy", "all samples accuracy",
                          "sample efficiency"]
    assert 0 <= out["accuracy_100"] <= 1 and 0 <= out["accuracy_all"] <= 1
    capsys.readouterr()
    results = toy_dr.main(["--device", "cpu", "--n", "1000"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" model")[0] for ln in lines] == [
        "Disentangled", "ERM", "Entangled"]
    assert all(0 <= a <= 1 for pair in results.values() for a in pair)


@pytest.mark.parametrize("cli,args", [
    ("main_semi", ["--image_size", "16", "--n_samples", "96"]),
    ("main_classifier", ["--image_size", "16", "--n_samples", "96"]),
    ("metric", ["--checkpoint", "x", "--classifier_checkpoint", "y"]),
    ("inference", ["--checkpoint", "x"]),
    ("dr_main", ["--image_size", "16", "--n_samples", "96"]),
    ("dr_main_semi", ["--image_size", "16", "--n_samples", "96"]),
    ("dr_robustness", ["--checkpoint", "x"]),
    ("sample_efficiency", ["--checkpoint", "x"]),
    ("toy_dr", ["--n", "100"])])
def test_new_entry_points_need_the_card_by_default(tmp_path, cli, args):
    """No --device means cuda; without a card they stop before any work
    instead of running on the CPU."""
    import importlib
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    module = importlib.import_module(f"cdgvae_torch.cli.{cli}")
    if cli != "toy_dr":  # the one that writes no files
        args = args + ["--assets_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(args)
    assert os.listdir(tmp_path) == []
