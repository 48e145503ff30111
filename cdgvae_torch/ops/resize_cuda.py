"""Wrapper of the hand-written CUDA resize (``csrc/cv_resize.cu``):
OpenCV's fixed-point ``INTER_LINEAR`` of uint8 images, and its fused form
for part-mask groups.

Replaces no TPU kernel: it ports the ``cv2.resize`` of the JAX package's
CelebAMask-HQ preprocessing (``data/cv_resize.py::resize_linear`` stays
the plain version and the CPU path). A thread makes every channel of an
output pixel from one tap pair on a 2-D grid (the images or group
entries down, runs of 256 output pixels across). The library is built
by ``nvcc`` at first launch (``_build.py``) and bound with ``ctypes``.
Each function checks its inputs, launches on the current stream without
synchronising and raises if the launch fails. Neither falls back to the plain version.
The taps are ``data/cv_resize.py::packed_taps``: OpenCV's float32
arithmetic, done on the host.

``launches`` counts :func:`resize`'s kernels, ``mask_launches``
:func:`mask_groups`'s.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
mask_launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build("cv_resize", ["cv_resize.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cdgvae_cv_resize.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.cdgvae_cv_resize.restype = i
        lib.cdgvae_cv_resize_mask_groups.argtypes = [p, p, p, p, p, p, i, i,
                                                     i, i, i, p]
        lib.cdgvae_cv_resize_mask_groups.restype = i
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           numel: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.numel() != numel or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of {numel} "
                         f"elements, got {list(t.shape)}")


def _on_one_card(what: str, *tensors) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"{what} needs its tensors on one CUDA device, got "
                         f"{sorted(map(str, devices))}")


def _check_shape(shape: tuple, width: int, height: int) -> None:
    if len(shape) != 4 or min(shape[1:]) <= 0 or shape[0] < 0:
        raise ValueError(f"shape must be (n, h, w, c) with h, w, c > 0, got "
                         f"{shape}")
    if width <= 0 or height <= 0:
        raise ValueError(f"an output of {width}x{height}")


def resize(src: torch.Tensor, shape: tuple, taps: torch.Tensor, width: int,
           height: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """``cv2.resize(img, (width, height))`` of each of the ``shape`` = (n,
    h, w, c) uint8 images in ``src`` (contiguous, n * h * w * c elements)
    on its CUDA device, with ``taps`` int32 (``packed_taps(h, w, width,
    height)``): uint8 [n, height, width, c] as n * height * width * c
    elements (``out``, if given)."""
    _check_shape(shape, width, height)
    n, h, w, c = shape
    _check("src", src, torch.uint8, n * h * w * c)
    _check("taps", taps, torch.int32, 4 * (width + height))
    if out is None:
        out = torch.empty(n * height * width * c, dtype=torch.uint8,
                          device=src.device)
    _check("out", out, torch.uint8, n * height * width * c)
    _on_one_card("resize", src, taps, out)
    if n == 0:
        return out
    lib = _load()
    global launches
    with torch.cuda.device(src.device):
        rc = lib.cdgvae_cv_resize(src.data_ptr(), taps.data_ptr(),
                                  out.data_ptr(), n, h, w, c, width, height,
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"resize kernel launch failed: CUDA error {rc}")
        launches += 1
    return out


def mask_groups(masks: torch.Tensor, index: torch.Tensor, size: tuple,
                taps: torch.Tensor, starts: torch.Tensor, parts: torch.Tensor,
                width: int, height: int, out: torch.Tensor,
                accumulate: bool = False) -> torch.Tensor:
    """For each group entry e, 1 where any channel of any of its parts'
    resized pixels is nonzero. ``masks`` uint8 holds m masks of ``size`` =
    (h, w), mask k at element ``index[2k]`` with ``index[2k + 1]``
    channels ([h, w, channels], the file's own); ``starts`` int32
    [entries + 1] and ``parts`` int32 [starts[-1]] name entry e's masks
    ``parts[starts[e]:starts[e + 1]]``; ``taps`` as :func:`resize`'s (for
    [h, w]). The host checks the indices when it builds them. ``out`` uint8
    [entries, height, width] receives 0 or 1 a pixel; with ``accumulate``
    only the 1s are written, onto what is there."""
    if len(size) != 2 or min(size) <= 0:
        raise ValueError(f"size must be (h, w) with h, w > 0, got {size}")
    if width <= 0 or height <= 0:
        raise ValueError(f"an output of {width}x{height}")
    w = size[1]
    entries = starts.numel() - 1
    if entries < 0:
        raise ValueError("starts must hold at least one element")
    if masks.dtype != torch.uint8 or not masks.is_contiguous():
        raise TypeError(f"masks must be contiguous uint8, got {masks.dtype}")
    if masks.numel() >= 2 ** 31:
        raise ValueError(f"masks of {masks.numel()} bytes: index is int32")
    if index.numel() % 2:
        raise ValueError(f"index must hold (offset, channels) pairs, got "
                         f"{index.numel()} elements")
    _check("index", index, torch.int32, index.numel())
    _check("taps", taps, torch.int32, 4 * (width + height))
    _check("starts", starts, torch.int32, entries + 1)
    _check("parts", parts, torch.int32, parts.numel())
    _check("out", out, torch.uint8, entries * height * width)
    _on_one_card("mask_groups", masks, index, taps, starts, parts, out)
    if entries == 0:
        return out
    lib = _load()
    global mask_launches
    with torch.cuda.device(masks.device):
        rc = lib.cdgvae_cv_resize_mask_groups(
            masks.data_ptr(), index.data_ptr(), taps.data_ptr(),
            starts.data_ptr(), parts.data_ptr(), out.data_ptr(), entries, w,
            width, height, int(accumulate),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mask-group resize kernel launch failed: CUDA"
                               f" error {rc}")
        mask_launches += 1
    return out
