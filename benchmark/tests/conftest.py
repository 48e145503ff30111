"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests`` from the repository's root)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def run_py():
    """Run Python ``code`` in a fresh process from the repository's root
    (a process of its own: the test runner's plugins may have loaded JAX,
    which a run refuses), two CPU threads; returns the last line of its
    standard output parsed as JSON."""
    def run(code: str, timeout: float = 600):
        env = dict(os.environ, OMP_NUM_THREADS="2")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=timeout)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])
    return run


# small CPU sizes of each configuration: the published widths where the
# CPU holds them (the pendulum's 64 px decoder bands), fewer rows
SMALL = {"pendulum-cdgvae": {"n_samples": 1024},
         "celeba-cdgvae": {"img_size": 32, "conv_dim": 4, "n_train": 96}}
