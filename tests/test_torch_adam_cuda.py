"""The card's ``capturable`` Adam (``train/steps.py::make_optimizer(...,
capturable=True)``, the default optimizer of every trainer on a CUDA
device) held to optax's update. No JAX here: the card-only tests (marker
``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_adam_cuda.py

and skip without a card. ``tools/adam_check.py::compare`` feeds the same
float32 gradients (numpy, seeded) to the ``capturable`` Adam, to the same
Adam inside a captured CUDA graph (its first step eager, then 200
replays), to the plain Adam, and to a float64 transcription of optax's
update, for the supervised CDG-VAE (16 and 64 px), the InfoMax pair (lr
1e-3 and lr_D 1e-4), the TVAE's weight decay 1e-5 and the packed CelebA
buffers.

Tolerances (``tools/adam_check.py``): after 1 step atol 1e-7 against the
float64 update, the CPU tests' figure for "Adam fed the same gradients"
(``tests/test_torch_graph_paths.py``); after 200 steps (the graph: 200
replays) max |d| <= 1e-6 against it and <= 3 x the plain Adam's own max
|d| on the same gradients. The graphed update equals the eager one at
every step read.
"""
import pytest
import torch

from cdgvae_torch.tools import adam_check


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(adam_check.CASES))
def test_capturable_adam_is_held_to_the_reference(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the capturable Adam runs only "
                    "on the card")
    make_build, wd = adam_check.CASES[case]
    result = adam_check.compare(make_build(), "cuda", weight_decay=wd)
    print(adam_check.format_result(case, result))
    assert adam_check.violations(result) == []
    assert result["graphed"] == result["capturable"]
