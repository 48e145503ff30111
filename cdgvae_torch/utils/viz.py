"""The recon figure (port of ``cdgvae_tpu/utils/viz.py:15-28``).

The GPU machine has no matplotlib, so the panels are tiled into one uint8
array and written as a PNG with the standard library's ``zlib`` and
``struct``. The panels are the reference's (``clip((x + 1) / 2, 0, 1)``,
at most ``n`` of them, three to a row); matplotlib's figure margins and
scaling are not reproduced.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PAD = 2  # white pixels between and around the panels


def recon_grid(xhat: np.ndarray, n: int = 9, cols: int = 3) -> np.ndarray:
    """The first ``min(n, len(xhat))`` images [H, W, 3] in [-1, 1] tiled
    ``cols`` to a row on white: [rows*(H+PAD)+PAD, cols*(W+PAD)+PAD, 3]
    uint8."""
    xhat = np.asarray(xhat)
    n = min(n, len(xhat))
    h, w = xhat.shape[1:3]
    rows = max(1, -(-n // cols))
    grid = np.full((rows * (h + PAD) + PAD, cols * (w + PAD) + PAD, 3), 255,
                   dtype=np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        y, x = PAD + r * (h + PAD), PAD + c * (w + PAD)
        panel = np.clip((xhat[i] + 1) / 2, 0, 1)
        grid[y:y + h, x:x + w] = np.rint(panel * 255).astype(np.uint8)
    return grid


def write_png(path: str, rgb: np.ndarray):
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def viz_recon_grid(xhat: np.ndarray, path: str, n: int = 9) -> np.ndarray:
    """3x3 grid of reconstructions in [0, 1] written to ``path``; returns
    the uint8 picture."""
    grid = recon_grid(xhat, n)
    write_png(path, grid)
    return grid
