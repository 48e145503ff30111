"""``cli.celeba_main --packed_params`` at 32 px, conv_dim 4 on the CPU:
``state.pkl`` written packed equals the one written unpacked, byte for
byte, in f32 and bf16; ``--resume`` across layouts continues the
uninterrupted run; ``--dp 2`` over gloo trains packed as it trains
unpacked. The JAX side of the packed layout is in
``tests/test_torch_packing.py``."""
import json

import pytest
import torch

from cdgvae_torch.cli import celeba_main

SMALL = ["--device", "cpu", "--img_size", "32", "--conv_dim", "4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as the other CelebA test files run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(tmp_path, name, *extra, epochs=1):
    out = tmp_path / name
    celeba_main.main(SMALL + ["--epochs", str(epochs), "--assets_dir",
                              str(out), *extra])
    return out / "celeba_CDGVAE_linear"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cli_state_pkl_byte_equal_across_layouts(tmp_path, dtype):
    extra = ["--bf16"] if dtype == "bf16" else []
    packed = _run(tmp_path, "packed", *extra)
    plain = _run(tmp_path, "plain", "--packed_params", "false", *extra)
    assert (packed / "state.pkl").read_bytes() == \
        (plain / "state.pkl").read_bytes()
    assert json.load(open(packed / "config.json"))["packed_params"] is True


@pytest.mark.parametrize("first", ["packed", "unpacked"])
def test_cli_resume_across_layouts(tmp_path, first):
    """One epoch in one layout, resumed to two in the other: the
    uninterrupted run's checkpoint, byte for byte."""
    flag = {"packed": "true", "unpacked": "false"}
    other = "unpacked" if first == "packed" else "packed"
    full = _run(tmp_path, "full", "--packed_params", flag[first], epochs=2)
    part = _run(tmp_path, "part", "--packed_params", flag[first])
    _run(tmp_path, "part", "--packed_params", flag[other], "--resume",
         str(part), epochs=2)
    assert (full / "state.pkl").read_bytes() == \
        (part / "state.pkl").read_bytes()


def test_cli_dp2_gloo_packed_equals_unpacked(tmp_path):
    """--dp 2 on the CPU: two gloo ranks, the packed layout's gradient
    buffer the one the mean runs on; the checkpoint equals the unpacked
    run's byte for byte."""
    outs = [_run(tmp_path, f"dp_{flag}", "--packed_params", flag, "--dp",
                 "2", "--batch_size", "8") for flag in ("true", "false")]
    assert outs[0].joinpath("state.pkl").read_bytes() == \
        outs[1].joinpath("state.pkl").read_bytes()
