"""Wrapper of the hand-written CUDA JPEG reconstruction
(``csrc/jpeg_reconstruct.cu``).

Replaces no TPU kernel: it ports the pixel reconstruction that
``cv2.imread`` gives the JAX package's CelebAMask-HQ preprocessing
(``data/jpeg.py::reconstruct`` and ``_orient`` stay the plain version and
the CPU path). The library is built by ``nvcc`` at first launch
(``_build.py``) and bound with ``ctypes``. :func:`reconstruct` checks its
inputs, launches the one kernel (IDCT, upsampling, colour and
orientation, the samples kept in shared memory) on the current stream
without synchronising, and raises if the launch fails. It never falls
back to the plain version.

``launches`` counts the kernels launched: one a call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# data/jpeg.py::JpegCoefficients.colour, in the kernel's numbering
COLOURS = ("ycc", "rgb", "grey")
# csrc/jpeg_reconstruct.cu's kNarrow: the largest input magnitude of an
# ISLOW IDCT pass whose every intermediate stays inside int32 (the source
# derives it; tests/test_torch_preprocess_kernels.py checks it)
IDCT_NARROW = 34531

launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build("jpeg_reconstruct",
                                           ["jpeg_reconstruct.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        sampling = ctypes.POINTER(ctypes.c_int)
        lib.cdgvae_jpeg_reconstruct.argtypes = [p, p, p, p, p, i, i, i, i,
                                                sampling, i, p]
        lib.cdgvae_jpeg_reconstruct.restype = i
        _lib = lib
    return _lib


def blocks(height: int, width: int, sampling: tuple) -> list:
    """(blocks down, blocks across) of each component of a frame, as
    ``data/jpeg.py::_frame`` lays them out: whole MCUs."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    return [(mcuy * v, mcux * h) for h, v in sampling]


def _check_geometry(geometry: tuple) -> None:
    height, width, sampling, colour = geometry
    if height <= 0 or width <= 0:
        raise ValueError(f"a frame of {width}x{height}")
    if len(sampling) not in (1, 3):
        raise ValueError(f"{len(sampling)} components; only 1 or 3")
    if colour not in COLOURS or (colour == "grey") != (len(sampling) == 1):
        raise ValueError(f"colour {colour!r} with {len(sampling)} "
                         "components")
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    for h, v in sampling:
        if not (1 <= h <= 4 and 1 <= v <= 4) or hmax % h or vmax % v:
            raise ValueError(f"sampling {sampling} is not integer ratios "
                             "of factors 1-4")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           numel: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.numel() != numel or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of {numel} "
                         f"elements, got {list(t.shape)}")


def reconstruct(coef: torch.Tensor, quant: torch.Tensor,
                orientation: torch.Tensor, geometry: tuple,
                out: torch.Tensor | None = None,
                wide: torch.Tensor | None = None) -> torch.Tensor:
    """The pixels of n files of one ``geometry`` (``(height, width,
    sampling, colour)``, ``data/jpeg.py::JpegCoefficients.geometry``) on
    their CUDA device, in one launch.

    ``coef`` int16 holds every component's blocks, component-major: [n,
    blocks down, blocks across, 64] (natural order) of component 0, then of
    1 and 2, starting at a 4-byte boundary (``data/staging.py``'s pieces
    start on whole words); ``quant`` int32 [n, components, 64] the files'
    tables;
    ``orientation`` int32 [n] their EXIF orientations. Returns uint8 of n *
    height * width * 3 elements (``out``, if given): file f's BGR image at
    f * height * width * 3, [height, width, 3] in its orientation's frame
    ([width, height, 3] for 5-8). ``wide``, an int32 [4] tensor on the
    same device if given, gets the kernel's IDCT passes added to it, a
    warp's pass of 4 blocks (8 halo blocks) at a time: column passes in
    32 and in 64 bits, then row passes in 32 and in 64 bits."""
    _check_geometry(geometry)
    height, width, sampling, colour = geometry
    n = orientation.numel()
    count = n * sum(bh * bw for bh, bw in blocks(height, width, sampling))
    _check("coef", coef, torch.int16, count * 64)
    _check("quant", quant, torch.int32, n * len(sampling) * 64)
    _check("orientation", orientation, torch.int32, n)
    if coef.data_ptr() % 4:
        raise ValueError("coef must start at a 4-byte boundary (its blocks "
                         "are read as 4-byte words)")
    if wide is not None:
        _check("wide", wide, torch.int32, 4)
    if out is None:
        out = torch.empty(n * height * width * 3, dtype=torch.uint8,
                          device=coef.device)
    _check("out", out, torch.uint8, n * height * width * 3)
    tensors = (coef, quant, orientation, out) + (
        () if wide is None else (wide,))
    devices = {t.device for t in tensors}
    if len(devices) != 1 or coef.device.type != "cuda":
        raise ValueError("reconstruct needs its tensors on one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    if n == 0:
        return out
    lib = _load()
    factors = (ctypes.c_int * 6)(*[k for hv in sampling for k in hv])
    global launches
    with torch.cuda.device(coef.device):
        rc = lib.cdgvae_jpeg_reconstruct(
            coef.data_ptr(), quant.data_ptr(), orientation.data_ptr(),
            out.data_ptr(), None if wide is None else wide.data_ptr(), n,
            height, width, len(sampling), factors, COLOURS.index(colour),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"JPEG reconstruction kernel launch failed: "
                               f"CUDA error {rc}")
        launches += 1
    return out
