"""On the card: one short run of each cell prints a correct result line
(the card decides inside the test; it skips without one)."""
import json
import subprocess
import sys

import pytest

from benchmark.manifest import ROOT

CELLS = ["pendulum-cdgvae.fixed", "pendulum-cdgvae.online",
         "celeba-cdgvae.f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483901", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
