"""PNG dataset trees in the reference's on-disk format (port of
``cdgvae_tpu/data/png_io.py:34-115``).

A tree is ``<root>/{train,test}/a_<f1>_..._<fk>.png``, one image a sample,
its labels in the file name rounded to 4 decimals.

* :func:`save_png_dataset` renders the factors on the device in chunks,
  each into one preallocated buffer, converts each chunk to uint8 on the
  device and writes the files with ``utils/viz.py::write_png`` (filter 0,
  so the bytes differ from PIL's adaptively filtered files; the pixels do
  not).
* :func:`load_png_dataset` reads a tree without PIL: :func:`decode_pngs`
  inflates every file with ``zlib`` and undoes the scanline filters of
  all images of one shape at once on the host, by the unfilter that
  :func:`unfilter_for` the device picks: on a CUDA device the native one
  (``data/png_native.py``, host C++), elsewhere the plain one,
  :func:`_unfilter`, a numpy pass a row; on the device,
  :func:`resize_bicubic` is a copy of Pillow's default ``Image.resize``
  filter (bicubic, a = -0.5, 22-bit fixed-point weights, the horizontal
  pass first, integer arithmetic, so every device gives Pillow's bytes),
  and the images are normalised by ``(x - 127.5) / 127.5``.
* :func:`read_png_bgr` reads 8-bit greyscale, RGB and RGBA files as
  ``cv2.imread(path, IMREAD_COLOR)`` does: BGR, grey replicated to three
  channels, alpha dropped (the CelebAMask-HQ part masks); the native
  unfilter writes that layout itself.

File names are sorted, as the JAX package sorts them (the reference's
``os.listdir`` order is filesystem-dependent); the order matters only for
the ``labeled_ratio`` truncation.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.viz import write_png
from . import png_native

__all__ = ["save_png_dataset", "load_png_dataset", "sample_filename",
           "decode_pngs", "read_png_bgr", "resize_bicubic", "unfilter_for"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel (grey, RGB, RGBA); grey only where
# the caller asks for it
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_NAMES = {0: "greyscale", 3: "palette", 4: "greyscale with alpha"}
# samples a pixel -> the samples of B, G, R in cv2.imread's IMREAD_COLOR
_BGR = {1: [0, 0, 0], 3: [2, 1, 0], 4: [2, 1, 0]}
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point weights
# (v - 127.5) / 127.5 of each uint8 level in float32, as numpy computes it.
# Looked up, not computed: CUDA divides a tensor by a Python scalar as a
# product with its reciprocal, an ulp away from the quotient.
_LEVELS = (np.arange(256, dtype=np.float32) - 127.5) / 127.5


def sample_filename(fields) -> str:
    """Reference filename for one sample: ``a_<f1>_..._<fk>.png`` with
    4-decimal rounding."""
    return "a_" + "_".join(str(round(float(v), 4)) for v in fields) + ".png"


def _to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float32 -> uint8 on the tensor's device, rounding as numpy's
    ``clip(rint(x * 127.5 + 127.5))`` does: the product and the sum are
    two rounded float32 operations, then half to even."""
    scaled = img * 127.5
    return torch.round(scaled + 127.5).clamp_(0, 255).to(torch.uint8)


def save_png_dataset(root: str, factors: np.ndarray, is_test: np.ndarray,
                     image_size: int = 96, background_col: int | None = None,
                     chunk: int = 2048, device: str | torch.device = "cuda"
                     ) -> tuple[int, int]:
    """Render ``factors`` [n, k] on ``device`` and write the reference PNG
    tree under ``root``. Columns 0:4 are the renderer's factors, and every
    column goes into the file name; ``background_col`` names the DR
    family's background column. Returns (n_train, n_test) written."""
    from ..ops.renderer import render

    device = resolve_device(device)
    factors = np.asarray(factors, dtype=np.float64)
    is_test = np.asarray(is_test, dtype=bool)
    dirs = [os.path.join(root, "train"), os.path.join(root, "test")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)

    buf = torch.empty((min(chunk, len(factors)), image_size, image_size, 3),
                      dtype=torch.float32, device=device)
    counts = [0, 0]
    with ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 8)) as pool:
        for i in range(0, len(factors), chunk):
            f = factors[i:i + chunk]
            out = buf[:len(f)]
            bg = None if background_col is None else torch.as_tensor(
                f[:, background_col], dtype=torch.float32, device=device)
            render(torch.as_tensor(np.ascontiguousarray(f[:, :4]),
                                   dtype=torch.float32, device=device),
                   size=image_size, background=bg, out=out)
            imgs = _to_uint8(out).cpu().numpy()
            paths = []
            for j, row in enumerate(f):
                test = bool(is_test[i + j])
                paths.append(os.path.join(dirs[test], sample_filename(row)))
                counts[test] += 1
            # zlib releases the GIL: the files of a chunk compress in
            # parallel; list() re-raises a failed write
            list(pool.map(write_png, paths, imgs))
    return counts[0], counts[1]


def _read_png(path: str, grey: bool = False
              ) -> tuple[tuple[int, int, int], bytes]:
    """One file's ((height, width, channels), inflated scanlines); 8-bit
    greyscale only with ``grey``."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or (colour == 0 and not grey):
        raise ValueError(f"{path}: colour type {colour} "
                         f"({_COLOUR_NAMES.get(colour, 'unknown')}) is not "
                         "supported; only 8-bit RGB (2) and RGBA (6)"
                         + (" and greyscale (0)" if grey else ""))
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported; "
                         "only 8")
    if interlace:
        raise ValueError(f"{path}: interlace method {interlace} (Adam7) is "
                         "not supported")
    # inflated into one buffer of the scanlines' size: zlib releases the
    # interpreter lock once, where a growing buffer takes it back a block
    return (h, w, _CHANNELS[colour]), zlib.decompress(
        b"".join(idat), bufsize=max(1, h * (1 + w * _CHANNELS[colour])))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters of ``raw`` [n, h, 1 + w*bpp] uint8 (each
    row's filter byte first) across all n images: [n, h, w*bpp] uint8.

    Each row is one step; a row's images are grouped by filter type, and
    a row whose images all use one type (every row of a ``write_png``
    file, filter 0) is one slice. Sub is a uint8 cumulative sum along the
    row (mod 256, as the filter's sum is); Average and Paeth depend on the
    pixel to their left, so they walk the row's pixels, each step
    vectorised over the images."""
    n, h, stride = raw.shape
    w = (stride - 1) // bpp
    out = np.empty((n, h, w * bpp), np.uint8)
    prev = np.zeros((n, w * bpp), np.uint8)
    for r in range(h):
        kinds = raw[:, r, 0]
        row = raw[:, r, 1:]
        cur = out[:, r]
        present = np.unique(kinds)
        for kind in present:
            sel = (slice(None) if len(present) == 1
                   else np.nonzero(kinds == kind)[0])
            x, up = row[sel], prev[sel]
            m = len(x)
            if kind == 0:
                cur[sel] = x
            elif kind == 1:
                cur[sel] = np.cumsum(x.reshape(m, w, bpp), axis=1,
                                     dtype=np.uint8).reshape(m, -1)
            elif kind == 2:
                cur[sel] = x + up
            elif kind in (3, 4):
                x16 = x.reshape(m, w, bpp).astype(np.int16)
                up16 = up.reshape(m, w, bpp).astype(np.int16)
                res = np.empty_like(x16)
                left = np.zeros((m, bpp), np.int16)
                up_left = np.zeros((m, bpp), np.int16)
                for px in range(w):
                    b = up16[:, px]
                    pred = ((left + b) >> 1 if kind == 3
                            else _paeth(left, b, up_left))
                    left = (x16[:, px] + pred) & 0xFF
                    res[:, px] = left
                    up_left = b
                cur[sel] = res.astype(np.uint8).reshape(m, -1)
            else:
                raise ValueError(f"PNG filter type {kind} is not one of 0-4")
        prev = cur
    return out


def unfilter_for(device) -> str:
    """The unfilter for files whose pixels go to ``device``: native for a
    CUDA device, its library built and loaded now, so that a failed build
    raises here and nothing falls back to the plain unfilter; plain on the
    CPU."""
    if torch.device(device).type == "cuda":
        png_native.load()
        return "native"
    return "plain"


def _decode(paths: list[str], grey: bool, unfilter: str, bgr: bool
            ) -> list[np.ndarray]:
    """The pixels of each file of ``paths``, in order: [h, w, channels]
    uint8, or with ``bgr`` [h, w, 3] as ``cv2.imread`` gives them. Files
    of one shape are unfiltered together, by ``unfilter`` (``"plain"`` or
    ``"native"``)."""
    if unfilter not in ("plain", "native"):
        raise ValueError(f"unfilter {unfilter!r} is not 'plain' or 'native'")
    files = [_read_png(p, grey) for p in paths]
    groups: dict[tuple, list[int]] = {}
    for i, (shape, _) in enumerate(files):
        groups.setdefault(shape, []).append(i)
    images: list = [None] * len(paths)
    for (h, w, ch), idx in groups.items():
        stride = 1 + w * ch
        raw = np.empty((len(idx), h, stride), np.uint8)
        for k, i in enumerate(idx):
            body = files[i][1]
            if len(body) != h * stride:
                raise ValueError(f"{paths[i]}: {len(body)} bytes of "
                                 f"scanlines, expected {h * stride}")
            raw[k] = np.frombuffer(body, np.uint8).reshape(h, stride)
        if unfilter == "native":
            pixels = np.empty((len(idx), h, w, 3 if bgr else ch), np.uint8)
            png_native.unfilter(raw, ch, pixels if bgr else pixels.reshape(
                len(idx), h, w * ch), bgr)
        else:
            pixels = _unfilter(raw, ch).reshape(len(idx), h, w, ch)
            if bgr:
                pixels = pixels[..., _BGR[ch]]
        for k, i in enumerate(idx):
            images[i] = pixels[k]
    return images


def decode_pngs(paths: list[str], grey: bool = False,
                unfilter: str = "plain") -> list[np.ndarray]:
    """Decode 8-bit RGB or RGBA PNGs (non-interlaced), and with ``grey``
    8-bit greyscale ones, to [h, w, channels] uint8 arrays, in ``paths``
    order, their rows unfiltered by ``unfilter`` (``"plain"`` or
    ``"native"``). Files of one shape are unfiltered together. The files
    are read and inflated one after another: for files of a few kilobytes,
    threads contend for the interpreter lock and read slower."""
    return _decode(paths, grey, unfilter, bgr=False)


def read_png_bgr(paths: list[str], unfilter: str = "plain"
                 ) -> list[np.ndarray]:
    """``cv2.imread(path, IMREAD_COLOR)`` of 8-bit greyscale, RGB or RGBA
    PNGs: BGR uint8 [h, w, 3] arrays, grey replicated, alpha dropped; the
    rows unfiltered by ``unfilter`` (``"plain"`` or ``"native"``)."""
    return _decode(paths, True, unfilter, bgr=True)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel, a = -0.5."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: each
    output pixel's first input pixel and count of input pixels [out], and
    its fixed-point weights [out, ksize] (zero past the count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = _bicubic((np.arange(xmax) + xmin - center + 0.5)
                     * (1.0 / filterscale))
        total = 0.0  # summed in order, as Pillow does
        for v in k:
            total += v
        if total != 0.0:
            k = k / total
        fixed = np.where(k < 0, -0.5 + k * (1 << _PRECISION_BITS),
                         0.5 + k * (1 << _PRECISION_BITS))
        weights[xx, :xmax] = np.trunc(fixed).astype(np.int64)
        first[xx], count[xx] = xmin, xmax
    return first, count, weights


def _resample_axis(img: torch.Tensor, first: np.ndarray, count: np.ndarray,
                   weights: np.ndarray, axis: int) -> torch.Tensor:
    """One of Pillow's passes along ``axis`` of uint8 [n, h, w, c]: a
    fixed-point weighted sum, rounded, shifted and clipped to uint8.

    The sums run as one float64 product with an [in, out] matrix of the
    integer weights: every partial sum is an integer below 2**53, so the
    product is exact, on any device and in any summation order, and
    equals Pillow's integer sums."""
    mat = np.zeros((img.shape[axis], len(first)))
    for j, (x0, m) in enumerate(zip(first, count)):
        mat[x0:x0 + m, j] = weights[j, :m]
    acc = img.movedim(axis, -1).to(torch.float64) @ torch.as_tensor(
        mat, device=img.device)
    acc = acc.to(torch.int64) + (1 << (_PRECISION_BITS - 1))
    return (acc >> _PRECISION_BITS).clamp_(0, 255).to(
        torch.uint8).movedim(-1, axis)


def _premultiply(img: torch.Tensor) -> torch.Tensor:
    """Pillow's RGBA -> RGBa: each colour times alpha / 255, rounded as its
    ``MULDIV255`` does."""
    x = img.to(torch.int32)
    alpha = x[..., 3:]
    tmp = x[..., :3] * alpha + 128
    return torch.cat([((tmp >> 8) + tmp) >> 8, alpha], dim=-1).to(
        torch.uint8)


def _unpremultiply(img: torch.Tensor) -> torch.Tensor:
    """Pillow's RGBa -> RGBA: each colour times 255 / alpha, clipped,
    unchanged where alpha is 0 or 255."""
    x = img.to(torch.int32)
    alpha = x[..., 3:]
    scaled = torch.div(255 * x[..., :3], alpha.clamp(min=1),
                       rounding_mode="floor").clamp_(max=255)
    colour = torch.where((alpha == 0) | (alpha == 255), x[..., :3], scaled)
    return torch.cat([colour, alpha], dim=-1).to(torch.uint8)


def resize_bicubic(images: torch.Tensor, size: int) -> torch.Tensor:
    """Pillow's ``Image.resize((size, size))`` of uint8 [n, h, w, c] (c 3
    or 4), with its default bicubic filter, on the tensor's device: RGBA
    is premultiplied by its alpha first and unpremultiplied after, as
    Pillow resizes it."""
    n, h, w, c = images.shape
    if (h, w) == (size, size):
        return images.clone()
    rgba = c == 4
    img = _premultiply(images) if rgba else images
    first_v, count_v, weights_v = _coeffs(h, size)
    first_h, count_h, weights_h = _coeffs(w, size)
    if w != size:
        # Pillow resamples only the rows the vertical pass reads
        y0, y1 = int(first_v[0]), int(first_v[-1] + count_v[-1])
        img = _resample_axis(img[:, y0:y1], first_h, count_h, weights_h,
                             axis=2)
        first_v = first_v - y0
    if h != size:
        img = _resample_axis(img, first_v, count_v, weights_v, axis=1)
    return _unpremultiply(img) if rgba else img


def load_png_dataset(split_dir: str, image_size: int = 64,
                     device: str | torch.device = "cuda",
                     unfilter: str | None = None
                     ) -> tuple[torch.Tensor, np.ndarray]:
    """Load one ``{train,test}`` directory of reference-format PNGs: each
    file resized to ``image_size`` as Pillow resizes it, RGB kept, then
    ``(x - 127.5) / 127.5``; labels parsed from the file names. The rows
    are unfiltered by ``unfilter``, by default :func:`unfilter_for` the
    device. Returns (x [n, H, W, 3] float32 in [-1, 1] on ``device``,
    labels [n, k] float64)."""
    device = resolve_device(device)
    unfilter = unfilter or unfilter_for(device)
    names = sorted(f for f in os.listdir(split_dir) if f.endswith("png"))
    if not names:
        raise FileNotFoundError(f"no .png files in {split_dir}")
    decoded = decode_pngs([os.path.join(split_dir, f) for f in names],
                          unfilter=unfilter)
    groups: dict[tuple, list[int]] = {}
    for i, img in enumerate(decoded):
        groups.setdefault(img.shape, []).append(i)
    x = torch.empty((len(names), image_size, image_size, 3),
                    dtype=torch.uint8, device=device)
    for idx in groups.values():
        pixels = torch.as_tensor(np.stack([decoded[i] for i in idx]),
                                 device=device)
        x[torch.as_tensor(idx, device=device)] = resize_bicubic(
            pixels, image_size)[..., :3]
    labels = [[float(v) for v in n[:-4].split("_")[1:]] for n in names]
    return torch.as_tensor(_LEVELS, device=device)[x.int()], np.asarray(
        labels, dtype=np.float64)
