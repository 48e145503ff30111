"""The port stands alone: importing every cdgvae_torch module loads neither
JAX, optax, matplotlib, pandas, scikit-learn, PIL, networkx, OpenCV nor
anything of cdgvae_tpu (the GPU machine has none of them), and not scipy,
which only the PC p-values, the mixture, the copula normaliser and the
CelebA probe's fit import, when they run. No import statement of the port
or of chip_smoke.py, at any depth, names JAX, optax, pandas,
scikit-learn, OpenCV (``cv2``, which the JAX package's CelebA
preprocessing imports) or cdgvae_tpu, and none at a module's top level
names scipy."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import cdgvae_torch
names = [m.name for m in pkgutil.walk_packages(cdgvae_torch.__path__,
                                               "cdgvae_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "cdgvae_tpu",
                                    "matplotlib", "pandas", "wandb",
                                    "sklearn", "PIL", "networkx", "scipy",
                                    "cv2"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in ("cdgvae_torch.cli.main", "cdgvae_torch.ops.renderer_cuda",
                 "cdgvae_torch.train.scanned", "cdgvae_torch.utils.interop",
                 "cdgvae_torch.api", "cdgvae_torch.cli.common",
                 "cdgvae_torch.train.online", "cdgvae_torch.train.loop",
                 "cdgvae_torch.utils.checkpoint",
                 "cdgvae_torch.utils.logging", "cdgvae_torch.utils.viz",
                 "cdgvae_torch.cli.main_semi",
                 "cdgvae_torch.cli.main_classifier",
                 "cdgvae_torch.cli.metric", "cdgvae_torch.cli.inference",
                 "cdgvae_torch.eval.inference", "cdgvae_torch.eval.metric",
                 "cdgvae_torch.models.classifier",
                 "cdgvae_torch.eval.downstream",
                 "cdgvae_torch.data.pendulum_dr",
                 "cdgvae_torch.cli.sample_efficiency",
                 "cdgvae_torch.cli.dr_main", "cdgvae_torch.cli.dr_main_semi",
                 "cdgvae_torch.cli.dr_robustness",
                 "cdgvae_torch.cli.toy_dr", "cdgvae_torch.data.png_io",
                 "cdgvae_torch.cli.generate_data",
                 "cdgvae_torch.data.tabular.datasets",
                 "cdgvae_torch.models.tabular",
                 "cdgvae_torch.train.tabular_steps",
                 "cdgvae_torch.cli.tabular_main", "cdgvae_torch.utils.pc",
                 "cdgvae_torch.cli.dag_discovery",
                 "cdgvae_torch.eval.ml_efficacy",
                 "cdgvae_torch.eval.tabular_inference",
                 "cdgvae_torch.cli.tabular_inference",
                 "cdgvae_torch.data.tabular.errors",
                 "cdgvae_torch.data.tabular.mixture",
                 "cdgvae_torch.data.tabular.transformer",
                 "cdgvae_torch.data.tabular.null",
                 "cdgvae_torch.cli.tabular_main_tvae",
                 "cdgvae_torch.cli.tabular_inference_tvae",
                 "cdgvae_torch.utils.profiling",
                 "cdgvae_torch.models.sagan", "cdgvae_torch.models.resnet",
                 "cdgvae_torch.models.celeba", "cdgvae_torch.data.celeba",
                 "cdgvae_torch.data.prefetch",
                 "cdgvae_torch.train.celeba_steps",
                 "cdgvae_torch.cli.celeba_main",
                 "cdgvae_torch.ops.packing", "cdgvae_torch.data.jpeg",
                 "cdgvae_torch.data.png_native",
                 "cdgvae_torch.data.cv_resize",
                 "cdgvae_torch.cli.celeba_preprocess",
                 "cdgvae_torch.models.torchvision_resnet",
                 "cdgvae_torch.tools.celeba_pretrain",
                 "cdgvae_torch.tools.celeba_probe",
                 "cdgvae_torch.ops.jpeg_cuda", "cdgvae_torch.ops.resize_cuda",
                 "cdgvae_torch.data.staging",
                 "cdgvae_torch.tools.preprocess_pace",
                 "cdgvae_torch.tools.jpeg_loads"):
        assert name in result["modules"]


BARRED = ("jax", "jaxlib", "optax", "pandas", "sklearn", "cdgvae_tpu",
          "cv2")


def _imports(path: Path):
    """(top-level module name, at module level) of every import in a
    source file."""
    tree = ast.parse(path.read_text())
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in top


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "cdgvae_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_import_statement_names_a_barred_package(path):
    found = list(_imports(ROOT / path))
    assert not [name for name, _ in found if name in BARRED]
    if path != "chip_smoke.py":  # the script prints scipy's version
        assert not [name for name, top in found
                    if name == "scipy" and top]


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "cdgvae_tpu" not in src.replace(
        "cdgvae_tpu/ops/renderer_pallas.py", "")
