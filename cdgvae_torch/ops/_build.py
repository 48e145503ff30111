"""Build the package's native sources into shared libraries at first use.

Each library is a plain-C shared object (loaded with ``ctypes`` by its
wrapper) under ``build/cdgvae_torch/`` at the root of the checkout, a
directory that ``.gitignore`` lists: the CUDA sources compiled by ``nvcc``
for ``sm_90a`` (:func:`build`), the host C++ sources by the host's C++
compiler, ``$CXX`` or else ``c++`` (:func:`build_host`). The output path
carries a hash of the sources and flags (and of the host compiler), so an
edit rebuilds. Nothing here runs when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import shlex
import shutil
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
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _cxx() -> list[str]:
    """The host C++ compiler's command: ``$CXX`` (a command with its own
    flags, if any) or ``c++``, its program resolved on ``PATH``."""
    cmd = shlex.split(os.environ.get("CXX") or "c++")
    found = shutil.which(cmd[0]) if cmd else None
    if found is None:
        raise RuntimeError(f"C++ compiler {cmd[0] if cmd else '(empty)'!r} "
                           "not found: set CXX or put c++ on PATH to build "
                           "the host libraries")
    return [found, *cmd[1:]]


def _cxx_key(cmd: list[str]) -> list[str]:
    """What the host build's hash covers besides the sources: the command
    and what the compiler says its version is (a checkout copied to
    another machine rebuilds there)."""
    proc = subprocess.run([cmd[0], "--version"], capture_output=True,
                          text=True)
    return [*cmd, proc.stdout + proc.stderr]


def _digest(paths: list[Path], flags: list[str] = NVCC_FLAGS) -> str:
    """Hash of the flags and of each source's name and bytes."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str, sources: list[str]) -> Path:
    """Compile the CUDA sources ``csrc/<sources>`` with ``nvcc`` into
    ``lib<name>.so`` (once per source hash) and return its path. The
    compiler's report (registers, spills) is kept beside it as
    ``lib<name>.log``."""
    paths = [CSRC / s for s in sources]
    return _compile(name, paths, _digest(paths),
                    lambda: [_nvcc(), *NVCC_FLAGS])


def build_host(name: str, sources: list[str]) -> Path:
    """Compile the host C++ sources ``csrc/<sources>`` with the host's C++
    compiler into ``lib<name>.so`` (once per hash of the compiler, its
    flags and the sources) and return its path; raises ``RuntimeError``
    naming the compiler when it is missing or fails."""
    cmd = [*_cxx(), *CXX_FLAGS]
    paths = [CSRC / s for s in sources]
    return _compile(name, paths, _digest(paths, _cxx_key(cmd)), lambda: cmd)


def _compile(name: str, paths: list[Path], digest: str, command) -> Path:
    """``lib<name>.so`` of ``paths`` under the build directory of
    ``digest``, built there by ``command()`` (the compiler and its flags)
    unless it exists."""
    out_dir = BUILD_DIR / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    cmd = command()
    compiler = Path(cmd[0]).name
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, *map(str, paths)],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler} could not run building {name}: "
                           f"{e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}) building "
                           f"{name}:\n{proc.stderr}")
    (out_dir / f"lib{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib
