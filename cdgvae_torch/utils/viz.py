"""Figures (port of ``cdgvae_tpu/utils/viz.py:15-135``).

The GPU machine has no matplotlib, so every figure is a uint8 picture
written as a PNG with the standard library's ``zlib`` and ``struct``.
Image figures tile their panels (``clip((x + 1) / 2, 0, 1)``) on white,
``PAD`` pixels apart; matplotlib's margins, titles and labels are not
reproduced. Bar charts, heatmaps and graphs carry no text: one bar per
entry, one coloured cell per entry, or one disc per node; the values,
names and edges are printed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PAD = 2  # white pixels between and around the panels
BAR_W, BAR_GAP, BAR_H = 12, 8, 96  # bar chart geometry, pixels
CELL = 16  # heatmap cell, pixels
GRAPH_PX, NODE_R, HEAD = 240, 14, 3  # graph canvas, node radius, head mark
# matplotlib's coolwarm at 0, 0.5 and 1
_COOLWARM = np.array([[59, 76, 192], [221, 221, 221], [180, 4, 38]],
                     np.float64)


def tile(images: np.ndarray, cols: int) -> np.ndarray:
    """Images [n, H, W, 3] in [-1, 1] tiled ``cols`` to a row on white:
    [rows*(H+PAD)+PAD, cols*(W+PAD)+PAD, 3] uint8."""
    images = np.asarray(images)
    n, h, w = images.shape[:3]
    rows = max(1, -(-n // cols))
    grid = np.full((rows * (h + PAD) + PAD, cols * (w + PAD) + PAD, 3), 255,
                   dtype=np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        y, x = PAD + r * (h + PAD), PAD + c * (w + PAD)
        panel = np.clip((images[i] + 1) / 2, 0, 1)
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
    """The first ``min(n, len(xhat))`` reconstructions, three to a row,
    written to ``path``; returns the uint8 picture."""
    grid = tile(np.asarray(xhat)[:n], 3)
    write_png(path, grid)
    return grid


def viz_do_grid(images: np.ndarray, path: str, row_names=None) -> np.ndarray:
    """The do-intervention grid [node, n_values, H, W, 3]: one row per
    intervened node (``row_names`` top to bottom), one column per value."""
    images = np.asarray(images)
    node, k = images.shape[:2]
    grid = tile(images.reshape(node * k, *images.shape[2:]), k)
    write_png(path, grid)
    if row_names is not None:
        print(f"{path}: rows {', '.join(map(str, row_names[:node]))}")
    return grid


def viz_pair(x: np.ndarray, xhat: np.ndarray, path: str) -> np.ndarray:
    """Original and reconstruction side by side, images in [-1, 1]."""
    grid = tile(np.stack([x, xhat]), 2)
    write_png(path, grid)
    return grid


def viz_gam_blocks(blocks: np.ndarray, path: str) -> np.ndarray:
    """Per-block GAM decoder outputs [K, H, W, 3] in [-1, 1], in a row."""
    grid = tile(blocks, len(blocks))
    write_png(path, grid)
    return grid


def viz_bars(vals, names, ylabel: str, path: str, ylim=None) -> np.ndarray:
    """One bar per entry of ``vals``, heights scaled to ``ylim`` (default:
    from min(0, vals) to max(vals)); the values are printed."""
    vals = np.asarray(vals, dtype=np.float64)
    lo, hi = ylim if ylim else (min(0.0, vals.min()), vals.max())
    span = hi - lo if hi > lo else 1.0
    pic = np.full((BAR_H + 2 * PAD, len(vals) * (BAR_W + BAR_GAP) + BAR_GAP,
                   3), 255, np.uint8)
    base = PAD + BAR_H  # the row below the tallest bar's range
    for i, v in enumerate(vals):
        top = base - int(round(np.clip((v - lo) / span, 0, 1) * BAR_H))
        x = BAR_GAP + i * (BAR_W + BAR_GAP)
        pic[top:base, x:x + BAR_W] = (31, 119, 180)
    pic[base, :] = 0
    write_png(path, pic)
    print(f"{path}: {ylabel}: " + ", ".join(
        f"{n} {v:.4g}" for n, v in zip(names, vals)))
    return pic


def viz_heatmap(arr: np.ndarray, path: str) -> np.ndarray:
    """One cell per entry of ``arr`` [rows, cols], coloured blue (its
    minimum) through grey to red (its maximum), row 0 at the bottom as
    matplotlib's ``pcolor`` draws it."""
    arr = np.asarray(arr, dtype=np.float64)
    lo, hi = arr.min(), arr.max()
    t = (arr - lo) / (hi - lo) if hi > lo else np.full(arr.shape, 0.5)
    seg = np.minimum((t * 2).astype(int), 1)  # which half of the map
    frac = (t * 2 - seg)[..., None]
    rgb = _COOLWARM[seg] * (1 - frac) + _COOLWARM[seg + 1] * frac
    cells = np.rint(rgb[::-1]).astype(np.uint8)
    pic = np.repeat(np.repeat(cells, CELL, axis=0), CELL, axis=1)
    write_png(path, pic)
    return pic


def viz_graph(B: np.ndarray, names, path: str | None = None) -> np.ndarray:
    """A directed graph of adjacency ``B`` [n, n] (an edge i -> j where
    ``B[i, j] != 0``): the nodes as light blue discs on a circle, placed
    as networkx's ``circular_layout`` places them (node k at angle 2πk/n),
    each edge a black line with a square mark at its head. Prints the node
    names and the edge list; writes the picture to ``path`` if given and
    returns it."""
    B = np.asarray(B)
    n = B.shape[0]
    theta = np.linspace(0, 1, n + 1)[:-1] * 2 * np.pi
    xy = np.stack([np.cos(theta), np.sin(theta)], 1) if n > 1 \
        else np.zeros((n, 2))
    half = GRAPH_PX / 2 - NODE_R - 2 * HEAD - 2
    cx = GRAPH_PX / 2 + half * xy[:, 0]
    cy = GRAPH_PX / 2 - half * xy[:, 1]  # rows grow downwards
    pic = np.full((GRAPH_PX, GRAPH_PX, 3), 255, np.uint8)
    edges = [(i, j) for i in range(n) for j in range(n)
             if i != j and abs(B[i, j]) > 0]
    for i, j in edges:
        length = np.hypot(cx[j] - cx[i], cy[j] - cy[i])
        t = np.linspace(0, 1, int(2 * length) + 2)
        rows = np.rint(cy[i] + t * (cy[j] - cy[i])).astype(int)
        cols = np.rint(cx[i] + t * (cx[j] - cx[i])).astype(int)
        pic[rows, cols] = 0
        # the head mark, just outside the head node's disc
        back = (NODE_R + HEAD + 1) / length
        hr = int(round(cy[j] + back * (cy[i] - cy[j])))
        hc = int(round(cx[j] + back * (cx[i] - cx[j])))
        pic[hr - HEAD:hr + HEAD + 1, hc - HEAD:hc + HEAD + 1] = 0
    yy, xx = np.mgrid[:GRAPH_PX, :GRAPH_PX] + 0.5
    for k in range(n):
        d = np.hypot(xx - cx[k], yy - cy[k])
        pic[d <= NODE_R] = 0
        pic[d <= NODE_R - 1.5] = (173, 216, 230)
    if path:
        write_png(path, pic)
    label = f"{path}: " if path else ""
    print(f"{label}nodes (counter-clockwise from the right) "
          f"{', '.join(map(str, names[:n]))}; edges "
          + (", ".join(f"{names[i]} -> {names[j]}" for i, j in edges)
             or "none"))
    return pic
