"""Wrapper of the native JPEG entropy decoder (``csrc/jpeg_huffman.cpp``).

The library is host C++, built by the host's C++ compiler at first use
(``ops/_build.py::build_host``) and bound with ``ctypes``, which releases
the interpreter lock during a call: threads decoding files run at once.
:func:`decode_scan` checks its arguments, decodes one scan into the
caller's coefficient arrays and raises the plain decoder's ``ValueError``
texts (``data/jpeg.py``). It never falls back to the plain decoder.

``scans`` counts the scans decoded natively.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import _build

scans = 0
_lib = None
_lock = threading.Lock()

# the return codes of cdgvae_jpeg_decode_scan, as data/jpeg.py words them
_ERRORS = {1: "corrupt JPEG data: bad Huffman code",
           2: "truncated JPEG data",
           3: "negative shift count"}
_TABLE = 1 << 16


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; raises
    ``RuntimeError`` naming the compiler when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host("jpeg_huffman",
                                                    ["jpeg_huffman.cpp"])))
            p = ctypes.c_void_p
            lib.cdgvae_jpeg_decode_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, p, p, p, p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
            lib.cdgvae_jpeg_decode_scan.restype = ctypes.c_int
            _lib = lib
    return _lib


def decode_scan(ecs: bytes, comps: list, units: tuple, restart: int,
                where: str = "") -> None:
    """Huffman-decode one scan's entropy-coded bytes ``ecs`` (stuffed, with
    their RSTn markers) into coefficient arrays. ``comps`` holds, in scan
    order, ``(h, v, coef, dc, ac)``: the component's blocks in an MCU
    across and down (1, 1 in a scan of one component), its int16 array
    [rows, blocks across, 64] and its int32 lookup tables [65536]
    (``data/jpeg.py::_huffman_table``). ``units`` is the scan's MCUs
    ``(across, down)``, ``restart`` its interval in MCUs (0 for none);
    ``where`` prefixes an error's text."""
    global scans
    units_x, units_y = units
    if units_x < 0 or units_y < 0 or restart < 0:
        raise ValueError(f"negative MCU counts {units} or restart "
                         f"interval {restart}")
    for h, v, coef, dc, ac in comps:
        if h < 1 or v < 1:
            raise ValueError(f"a component of {h}x{v} blocks an MCU")
        if (coef.dtype != np.int16 or coef.ndim != 3 or coef.shape[2] != 64
                or not coef.flags.c_contiguous or not coef.flags.writeable):
            raise ValueError("coefficients must be a writeable C-contiguous "
                             f"int16 [rows, cols, 64] array, got "
                             f"{coef.dtype} {coef.shape}")
        if units_y * v > coef.shape[0] or units_x * h > coef.shape[1]:
            raise ValueError(f"{units_y}x{units_x} MCUs of {v}x{h} blocks "
                             f"do not fit {coef.shape[:2]} blocks")
        for table in (dc, ac):
            if (table.dtype != np.int32 or table.shape != (_TABLE,)
                    or not table.flags.c_contiguous):
                raise ValueError("a Huffman lookup must be a contiguous "
                                 f"int32 [{_TABLE}] array")
    n = len(comps)
    ptrs = ctypes.c_void_p * n
    geometry = np.array([(h, v, coef.shape[1]) for h, v, coef, _, _
                         in comps], np.int32).reshape(-1)
    rc = load().cdgvae_jpeg_decode_scan(
        ecs, len(ecs), n, ptrs(*[c[2].ctypes.data for c in comps]),
        geometry.ctypes.data, ptrs(*[c[3].ctypes.data for c in comps]),
        ptrs(*[c[4].ctypes.data for c in comps]), units_x, units_y, restart)
    with _lock:
        scans += 1
    if rc:
        raise ValueError(f"{where}{_ERRORS[rc]}")
