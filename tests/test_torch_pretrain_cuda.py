"""The CelebA trunk's pretraining (``cdgvae_torch/tools/celeba_pretrain.py``)
on the card. No JAX here: the card-only tests (marker ``cuda``) run on a
GPU machine with

    python -m pytest --noconftest -q tests/test_torch_pretrain_cuda.py

and skip without a card. Two tiny pretrainings on the card (32 px, 16
train and 8 test faces, batch 6, 2 epochs) write the same file byte for
byte (float32, TF32 off, deterministic cuDNN), and the first step's loss
on the card is the CPU's within a relative 1e-4: the same weights and
batch, float32 summed in other orders.
"""
import json
from pathlib import Path

import pytest
import torch

from cdgvae_torch.tools import celeba_pretrain

FLAGS = ["--n_train", "16", "--n_test", "8", "--img_size", "32",
         "--epochs", "2", "--batch", "6"]


@pytest.mark.cuda
def test_pretraining_on_the_card_repeats_and_matches_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tool's default device")
    sides, blobs = {}, {}
    for run in ("a", "b", "cpu"):
        out = tmp_path / run / "resnet18.pt"
        extra = ["--device", "cpu"] if run == "cpu" else []
        celeba_pretrain.main([*FLAGS, "--out", str(out), *extra])
        sides[run] = json.loads(Path(str(out) + ".json").read_text())
        blobs[run] = out.read_bytes()
    assert blobs["a"] == blobs["b"]
    assert sides["a"]["losses"] == sides["b"]["losses"]
    assert sides["a"]["card"] is not None and sides["cpu"]["card"] is None
    card, cpu = sides["a"]["losses"][0], sides["cpu"]["losses"][0]
    assert abs(card - cpu) <= 1e-4 * abs(cpu)
