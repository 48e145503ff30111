"""Split the render kernel's time into its compute and its stores.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.render_split

builds three variants of ``csrc/render.cu`` side by side (one ``nvcc`` each,
all started together, into the git-ignored ``build/``), and times each with
CUDA events at the main path's shapes, beside ``torch.Tensor.fill_`` of the
same output (a pure write of the same bytes, the card's practical store
rate):

- ``kernel``: the source as it is;
- ``compute``: every band rendered, none copied out of shared memory
  (what the arithmetic, the staging and the loop cost alone);
- ``stores``: every band filled with a constant instead of rendered (what
  the store path costs alone).

The variants are the source built with the ``RENDER_SPLIT`` switch that
``VARIANTS`` names.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from ..data.pendulum import sample_factors_real
from ..ops import _build

VARIANTS = {"kernel": 0, "compute": 1, "stores": 2}


def _build_all() -> dict:
    out_dir = _build.BUILD_DIR / "render_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(_build.CSRC / "render.cu")
    procs = {}
    for name, split in VARIANTS.items():
        so = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DRENDER_SPLIT={split}",
               "-o", str(so), src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{report}")
        fn = ctypes.CDLL(str(so)).cdgvae_render
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _time_us(fn, reps: int = 20, rounds: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps * 1e3)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("render_split: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    entries = _build_all()
    factors, is_test = sample_factors_real(seed=1, n=4949)
    f_all = torch.as_tensor(factors[~is_test, :4], dtype=torch.float32,
                            device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n in (3712, 2048, 128):
        f = f_all[:n]
        out = torch.empty((n, 64, 64, 3), device="cuda")
        cells = [f"fill_ {_time_us(lambda: out.fill_(1.0)):.2f}"]
        for name, fn in entries.items():
            def launch():
                rc = fn(f.data_ptr(), None, out.data_ptr(), n, 64, stream)
                if rc != 0:
                    raise RuntimeError(f"{name} launch: CUDA error {rc}")
            cells.append(f"{name} {_time_us(launch):.2f}")
        print(f"B={n} (us): " + ", ".join(cells) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
