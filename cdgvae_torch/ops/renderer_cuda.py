"""Wrapper of the hand-written CUDA render kernel (``csrc/render.cu``).

Replaces ``cdgvae_tpu/ops/renderer_pallas.py::render_pallas``. The library
is built by ``nvcc`` at first launch (``_build.py``) and bound with
``ctypes``. The wrapper checks its inputs, allocates the output (or takes
the caller's), launches on the current stream without synchronising, and
raises if the launch fails. It never falls back to the plain version.

``launches`` counts the kernels that ran: each launch on a stream that
runs it, and each launch a CUDA graph holds, once a replay
(:func:`count_replay`). A launch recorded into a graph being captured has
not run: it counts in ``captured`` instead, which the captured step reads
to know how many launches its replays make
(``train/scanned.py::CapturedStep``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# one output row of 3 float32 channels must fit a warp's 6 KB band buffer
# (render.cu: kMaxSize = kBandFloats / 3)
MAX_SIZE = 512

launches = 0
captured = 0
_lib = None


def _count_launch() -> None:
    """One launch: run now, or recorded into the graph being captured."""
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1


def count_replay(n: int) -> None:
    """A replayed CUDA graph ran the ``n`` launches its capture
    recorded."""
    global launches
    launches += n


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build("render", ["render.cu"])))
        lib.cdgvae_render.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.cdgvae_render.restype = ctypes.c_int
        _lib = lib
    return _lib


def render_cuda(factors: torch.Tensor, size: int = 64,
                background: torch.Tensor | None = None, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """factors [B, 4] (float32, or a float type cast to it) and optional
    background [B] 0/1 on one CUDA device -> [B, size, size, 3] float32 in
    [-1, 1], channels-last. ``out``, if given, is a contiguous float32
    [B, size, size, 3] tensor on the same device that receives the images
    and is returned."""
    if factors.device.type != "cuda":
        raise ValueError(f"render_cuda needs a CUDA tensor, got "
                         f"{factors.device}")
    if factors.ndim != 2 or factors.shape[1] != 4:
        raise ValueError(f"factors must be [B, 4], got {tuple(factors.shape)}")
    if not factors.is_floating_point():
        raise TypeError(f"factors must be floating point, got {factors.dtype}")
    if not factors.is_contiguous():
        raise ValueError("factors must be contiguous")
    if not 0 < size <= MAX_SIZE:
        raise ValueError(f"size must be in (0, {MAX_SIZE}], got {size}")
    factors = factors.to(torch.float32)
    n = factors.shape[0]
    bg_ptr = None
    if background is not None:
        if background.device != factors.device or background.shape != (n,):
            raise ValueError(f"background must be [{n}] on {factors.device}, "
                             f"got {tuple(background.shape)} on "
                             f"{background.device}")
        if not background.is_contiguous():
            raise ValueError("background must be contiguous")
        background = background.to(torch.float32)
        bg_ptr = background.data_ptr()
    shape = (n, size, size, 3)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=factors.device)
    elif (out.device != factors.device or out.dtype != torch.float32
          or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {list(shape)} "
                         f"tensor on {factors.device}, got {out.dtype} "
                         f"{list(out.shape)} on {out.device}")
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(factors.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cdgvae_render(factors.data_ptr(), bg_ptr, out.data_ptr(),
                               n, size, stream)
        if rc != 0:
            raise RuntimeError(f"render kernel launch failed: CUDA error "
                               f"{rc}")
        _count_launch()
    return out
