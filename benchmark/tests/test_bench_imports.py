"""No module of JAX or of the JAX package: the run's check compares
top-level names whole, the benchmark's files import neither, the
references import nothing of the program, and a module loaded after the
window (say, by a metric's reader) withholds the result."""
import ast
import json
import subprocess
import sys

import pytest

from benchmark.manifest import ROOT
from benchmark.run import FORBIDDEN, forbidden_modules

HERE = ROOT / "benchmark"


def imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    found = forbidden_modules({"jax": 1, "jax.numpy": 1, "jaxtyping": 1,
                               "cdgvae_tpu.ops": 1, "cdgvae_torch": 1,
                               "cdgvae_tpu_x": 1, "flax.linen": 1,
                               "numpy": 1})
    assert found == ["cdgvae_tpu.ops", "flax.linen", "jax", "jax.numpy"]


def test_no_file_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not imports(path) & set(FORBIDDEN), path


def test_the_references_import_nothing_of_the_program():
    refs = [*HERE.glob("configs/*.reference.py"), HERE / "plain.py"]
    assert len(refs) >= 3
    for path in refs:
        assert not imports(path) & {"cdgvae_torch", *FORBIDDEN}, path
        assert imports(path) <= {"__future__", "math", "numpy", "torch",
                                 "benchmark"}, path


EMIT = """
import sys
sys.path.insert(0, '.')
sys.path.insert(0, {fake!r})
from benchmark import run
from benchmark.manifest import load_module
if {load}:
    load_module({metric!r})
sys.exit(run.emit({{'correct': True, 'attempted': 1, 'failed': 0,
                    'metrics': {{}}, 'device': {{}}, 'checks': {{}}}}))
"""


@pytest.mark.parametrize("load", [True, False])
def test_a_module_loaded_before_the_result_withholds_it(tmp_path, load):
    # a metric's reader that imports a module named jax (a stand-in)
    (tmp_path / "jax.py").write_text("LOADED = True\n")
    metric = tmp_path / "stub_metric.py"
    metric.write_text("import jax\n\n\ndef read(ctx):\n    return 1.0\n")
    proc = subprocess.run(
        [sys.executable, "-c", EMIT.format(fake=str(tmp_path), load=load,
                                           metric=str(metric))],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if load:
        assert proc.returncode != 0 and "{" not in proc.stdout
        assert "jax" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.splitlines()[-1])["correct"]
