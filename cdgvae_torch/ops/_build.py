"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` into a plain-C shared
object (loaded with ``ctypes`` by its wrapper) under ``build/cdgvae_torch/``
at the root of the checkout, a directory that ``.gitignore`` lists. The
output path carries a hash of the sources and flags, so an edit rebuilds.
Nothing here runs when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cdgvae_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # keep every float32 operation rounded as the plain torch version
    # rounds it: no fused multiply-add, on the device or the host
    "--fmad=false", "-Xcompiler", "-ffp-contract=off",
    "-Xptxas", "-v",
]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest(paths: list[Path]) -> str:
    """Hash of the flags and of each source's name and bytes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str, sources: list[str]) -> Path:
    """Compile ``csrc/<sources>`` into ``lib<name>.so`` (once per source
    hash) and return its path. The compiler's report (registers, spills)
    is kept beside it as ``lib<name>.log``."""
    paths = [CSRC / s for s in sources]
    out_dir = BUILD_DIR / f"{name}-{_digest(paths)}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}:\n{proc.stderr}")
    (out_dir / f"lib{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib
