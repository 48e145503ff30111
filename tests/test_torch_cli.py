"""The port's pendulum CLI on the CPU: artifacts, the metric log's record
shape against the JAX package's, a resumed run against the uninterrupted
one (bit for bit), the resume guard, the eager protocol, --online and the
flags that are not ported. 16 px, 96 DGP samples (a 72-image train
split), batch 32.
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
from cdgvae_torch.cli import main
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


def _state(out):
    with open(os.path.join(out, CKPT, "state.pkl"), "rb") as f:
        raw = f.read()
    ck = load_checkpoint(os.path.join(out, CKPT))
    return raw, ck


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


@pytest.mark.parametrize("mode", ["dataset", "online"])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, capsys, mode):
    extra = ["--online"] if mode == "online" else []
    _main(tmp_path / "a", "--epochs", "2", *extra)
    _main(tmp_path / "a", "--epochs", "4", "--resume",
          str(tmp_path / "a" / CKPT), *extra)
    assert f"resumed from {tmp_path / 'a' / CKPT} at epoch 2" in \
        capsys.readouterr().out
    _main(tmp_path / "b", "--epochs", "4", *extra)
    raw_a, ck_a = _state(tmp_path / "a")
    raw_b, ck_b = _state(tmp_path / "b")
    assert ck_a["step"] == ck_b["step"] == 4
    _assert_trees_equal(ck_a["params"], ck_b["params"])
    _assert_trees_equal(ck_a["opt_state"], ck_b["opt_state"])
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
    (["--model", "InfoMax"], "item 8"),
    (["--labeled_ratio", "0.5"], "item 8"),
    (["--data_dir", "pngs"], "item 7"),
    (["--platform", "cpu"], "item 15"),
    (["--dp", "2"], "item 14"),
    (["--profile", "trace"], "item 15"),
    (["--online", "--eager"], "--online supports"),
])
def test_unported_flags_are_refused(tmp_path, capsys, args, why):
    with pytest.raises(SystemExit) as exc:
        _main(tmp_path, "--epochs", "1", *args)
    said = f"{exc.value.code} {capsys.readouterr().err}"
    assert why in said
    assert not os.path.exists(tmp_path / CKPT)


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
