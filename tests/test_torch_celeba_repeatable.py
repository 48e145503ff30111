"""The CelebA trainer's switches for repeatable runs: ``cli.celeba_main``
leaves TF32 off and cuDNN on its deterministic algorithms without
autotuning, on the CPU at the cut size README uses (32 px, conv_dim 4, on
the 64 synthetic faces), as on the card, where cuDNN's default
weight-gradient convolutions sum in an order that changes from call to
call (``cdgvae_torch/tools/celeba_determinism.py``; the card's check is
``tests/test_torch_library_cuda.py``)."""
import pytest
import torch

from cdgvae_torch.cli import celeba_main

SWITCHES = ("deterministic", "benchmark", "allow_tf32")


@pytest.fixture
def switches():
    """Set the switches to what they must not end as, and restore them."""
    before = ({k: getattr(torch.backends.cudnn, k) for k in SWITCHES},
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    for k, v in before[0].items():
        setattr(torch.backends.cudnn, k, v)
    torch.backends.cuda.matmul.allow_tf32 = before[1]


def _assert_repeatable():
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_float32_and_repeatable_sets_the_switches(switches):
    celeba_main.float32_and_repeatable()
    _assert_repeatable()


def test_celeba_main_runs_repeatable(switches, tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        celeba_main.main(["--device", "cpu", "--img_size", "32",
                          "--conv_dim", "4", "--epochs", "1",
                          "--assets_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    _assert_repeatable()
    assert (tmp_path / "celeba_CDGVAE_linear" / "state.pkl").exists()
