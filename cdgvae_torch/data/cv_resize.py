"""OpenCV's ``cv2.resize(img, (width, height))`` (``INTER_LINEAR``) of
uint8 images, on the tensor's device, bit for bit.

OpenCV resizes 8-bit images in fixed point (``resize.cpp``):

* each output column ``dx`` reads source columns ``sx`` and ``sx + 1``,
  ``fx = float((dx + 0.5) * scale - 0.5)``, ``sx = floor(fx)``, ``fx -=
  sx``, with ``scale = 1 / (width / w)`` in double; a column left of the
  first or right of the last reads the edge column with weight 1. The
  weights ``1 - fx`` and ``fx`` are float32, scaled by
  ``INTER_RESIZE_COEF_SCALE`` (2**11) and rounded to int16;
* rows take the same weights, unclamped, from rows clamped to the image;
* the horizontal pass sums in int32 (2**11 scale); the vertical pass is
  the SIMD one (``VResizeLinearVec_32s8u``) on every column: each row's
  sum shifted right by 4, multiplied by its weight keeping the high 16
  bits, the two added, then ``(t + 2) >> 2`` saturated to uint8. This
  build of OpenCV takes that path for every column of every width (held
  to ``cv2.resize`` at 96 -> 37 and at widths of 3 to 297 samples a row),
  not the exact ``(S0 * b0 + S1 * b1 + 2**21) >> 22`` of its scalar tail.

OpenCV sends an exact 2x downscale to ``INTER_AREA``, whose 2x2 mean
rounds as ``(a + b + c + d + 2) >> 2``; at exactly 2x the bilinear taps
are that 2x2 block with weights 1024 each, and the sums above give the
same integer, so one path serves both.

:func:`resize_linear` is the plain version and runs on the tensor's
device. :func:`resize_into` and :func:`mask_groups_into` take a chunk's
staged buffers (``data/celeba.py``): on a CUDA device they launch the
kernels of ``csrc/cv_resize.cu`` (``ops/resize_cuda.py``) with
:func:`packed_taps`, on the CPU they run :func:`resize_linear`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import resize_cuda

__all__ = ["resize_linear", "packed_taps", "resize_into", "mask_groups_into",
           "mask_groups_plain"]

_COEF_SCALE = 1 << 11


def _taps(in_size: int, out_size: int, clamp_weights: bool):
    """(first source index, second source index, int16 weight of each)
    of every output position, as OpenCV computes them."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        edge = (s < 0) | (s >= in_size - 1)
        f[edge] = 0
        s = np.clip(s, 0, in_size - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1),
            w0.astype(np.int64), w1.astype(np.int64))


def resize_linear(images: torch.Tensor, width: int,
                  height: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height))`` of each of uint8 [n, h, w, c]:
    uint8 [n, height, width, c] on the same device."""
    n, h, w, c = images.shape
    dev = images.device
    x0, x1, a0, a1 = (torch.as_tensor(t, device=dev)
                      for t in _taps(w, width, clamp_weights=True))
    y0, y1, b0, b1 = (torch.as_tensor(t, device=dev)
                      for t in _taps(h, height, clamp_weights=False))
    # the horizontal pass, only on the rows the vertical pass reads
    rows = torch.unique(torch.cat([y0, y1]))
    src = images[:, rows].to(torch.int32)
    a0, a1 = (a.to(torch.int32)[None, None, :, None] for a in (a0, a1))
    horiz = src[:, :, x0] * a0 + src[:, :, x1] * a1
    at = torch.searchsorted(rows, torch.stack([y0, y1]))
    s0, s1 = horiz[:, at[0]] >> 4, horiz[:, at[1]] >> 4
    b0, b1 = (b.to(torch.int32)[None, :, None, None] for b in (b0, b1))
    t = ((s0 * b0) >> 16) + ((s1 * b1) >> 16)
    return ((t + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def packed_taps(h: int, w: int, width: int, height: int) -> np.ndarray:
    """The taps of a resize of [h, w] images to [height, width] as the
    kernels take them: int32 x0, x1, a0, a1 (each ``width`` long), then y0,
    y1, b0, b1 (each ``height`` long), as :func:`_taps` computes them."""
    return np.concatenate([*_taps(w, width, clamp_weights=True),
                           *_taps(h, height, clamp_weights=False)]
                          ).astype(np.int32)


def resize_into(src: torch.Tensor, shape: tuple, width: int, height: int,
                out: torch.Tensor, taps: torch.Tensor | None = None
                ) -> torch.Tensor:
    """:func:`resize_linear` of the ``shape`` = (n, h, w, c) uint8 images
    in the flat ``src`` into the flat ``out`` (n * height * width * c): on
    a CUDA device by the kernel, with ``taps`` (:func:`packed_taps` on the
    device), on the CPU by :func:`resize_linear`."""
    if out.device.type == "cuda":
        return resize_cuda.resize(src, shape, taps, width, height, out)
    out.copy_(resize_linear(src.view(shape), width, height).reshape(-1))
    return out


def mask_groups_into(masks: torch.Tensor, index, size: tuple, taps,
                     starts, parts, width: int, height: int,
                     out: torch.Tensor, accumulate: bool = False
                     ) -> torch.Tensor:
    """For each group entry e, 1 where any channel of any of its masks'
    pixels is nonzero after :func:`resize_linear` to [height, width]:
    ``masks`` flat uint8, m masks of ``size`` = (h, w), mask k at
    ``index[2k]`` with ``index[2k + 1]`` channels; entry e's masks are
    ``parts[starts[e]:starts[e + 1]]`` (int32); ``out`` uint8 [entries,
    height, width], flat, receives 0 or 1 (with ``accumulate``, only the
    1s, onto what is there). On a CUDA device by the kernel (``taps`` as
    :func:`resize_into`'s), on the CPU by :func:`mask_groups_plain`."""
    if out.device.type == "cuda":
        return resize_cuda.mask_groups(masks, index, size, taps, starts,
                                       parts, width, height, out, accumulate)
    return mask_groups_plain(masks, index, size, starts, parts, width,
                             height, out, accumulate)


def mask_groups_plain(masks: torch.Tensor, index, size: tuple, starts,
                      parts, width: int, height: int, out: torch.Tensor,
                      accumulate: bool = False) -> torch.Tensor:
    """:func:`mask_groups_into`'s plain version, on the tensors' device:
    :func:`resize_linear` of the masks of each channel count,
    ``(parts != 0).any(-1)``, then each entry's ``any``."""
    h, w = size
    where = index.view(-1, 2).tolist()
    nonzero = torch.empty((len(where), height, width), dtype=torch.bool,
                          device=out.device)
    by_channels: dict = {}
    for k, (_, c) in enumerate(where):
        by_channels.setdefault(c, []).append(k)
    for c, ks in by_channels.items():
        batch = torch.stack([masks[where[k][0]:where[k][0] + h * w * c].view(
            h, w, c) for k in ks])
        nonzero[ks] = (resize_linear(batch, width, height) != 0).any(-1)
    grid = out.view(-1, height, width)
    bounds, idx = starts.tolist(), parts.tolist()
    for e in range(len(bounds) - 1):
        mine = idx[bounds[e]:bounds[e + 1]]
        hit = (nonzero[mine].any(0) if mine
               else torch.zeros((height, width), dtype=torch.bool,
                                device=out.device))
        grid[e] = (grid[e].bool() | hit) if accumulate else hit
    return out
