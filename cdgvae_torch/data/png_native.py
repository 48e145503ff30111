"""Wrapper of the native PNG unfilter (``csrc/png_unfilter.cpp``).

The library is host C++, built by the host's C++ compiler at first use
(``ops/_build.py::build_host``) and bound with ``ctypes``, which releases
the interpreter lock during a call: threads decoding files run at once.
:func:`unfilter` checks its arrays, undoes the scanline filters of a
batch of images of one shape into the caller's array and raises the plain
unfilter's ``ValueError`` text (``data/png_io.py::_unfilter``) for a
filter byte above 4. It never falls back to the plain unfilter.

``files`` counts the images unfiltered natively, one a PNG file.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import _build

files = 0
_lib = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; raises
    ``RuntimeError`` naming the compiler when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host("png_unfilter",
                                                    ["png_unfilter.cpp"])))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.cdgvae_png_unfilter.argtypes = [p, i64, i64, i64, i32, i32,
                                                p, p]
            lib.cdgvae_png_unfilter.restype = ctypes.c_int
            _lib = lib
    return _lib


def unfilter(raw: np.ndarray, bpp: int, out: np.ndarray,
             bgr: bool = False) -> np.ndarray:
    """Undo the scanline filters of ``raw`` [n, h, 1 + w*bpp] uint8 (each
    row's filter byte first; bpp 1, 3 or 4) into ``out``: [n, h, w*bpp]
    uint8, the files' samples, or with ``bgr`` [n, h, w, 3], what
    ``cv2.imread(path, IMREAD_COLOR)`` gives (grey replicated, B, G, R,
    alpha dropped). Returns ``out``. A filter byte above 4 raises the
    plain unfilter's ``ValueError``, with a note naming its image and
    row."""
    global files
    if bpp not in (1, 3, 4):
        raise ValueError(f"{bpp} bytes a pixel is not 1, 3 or 4")
    if (raw.dtype != np.uint8 or raw.ndim != 3 or raw.shape[2] < 1
            or (raw.shape[2] - 1) % bpp or not raw.flags.c_contiguous):
        raise ValueError("scanlines must be a C-contiguous uint8 [n, h, "
                         f"1 + w*{bpp}] array, got {raw.dtype} {raw.shape}")
    n, h, stride = raw.shape
    w = (stride - 1) // bpp
    shape = (n, h, w, 3) if bgr else (n, h, w * bpp)
    if (out.dtype != np.uint8 or out.shape != shape
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"the output must be a writeable C-contiguous uint8 "
                         f"{list(shape)} array, got {out.dtype} {out.shape}")
    bad = np.zeros(3, np.int64)
    rc = load().cdgvae_png_unfilter(raw.ctypes.data, n, h, w, bpp, int(bgr),
                                    out.ctypes.data, bad.ctypes.data)
    if rc:
        err = ValueError(f"PNG filter type {bad[2]} is not one of 0-4")
        err.add_note(f"image {bad[0]}, row {bad[1]}")
        raise err
    with _lock:
        files += n
    return out
