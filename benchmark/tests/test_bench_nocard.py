"""A measuring run without a card, or in a directory that holds only the
benchmark's files, fails and prints no result: it never falls back to
the CPU."""
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.manifest import ROOT


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pendulum-cdgvae.fixed", "--seed", "2147483777", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("what", ["benchmark alone"])
def test_benchmark_files_alone_fail(tmp_path, what):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0 and "{" not in proc.stdout
