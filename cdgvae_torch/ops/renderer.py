"""Pendulum scene rasteriser: geometry, the plain torch version, dispatch.

Port of ``cdgvae_tpu/ops/renderer.py``. The scene (sun disc, pendulum rod,
ball, shadow segment) is rasterised analytically with 1-px anti-aliased
coverage, composited over white in the reference's artist order and clipped
to matplotlib's default axes window (see the JAX module's docstring for the
geometry's provenance).

``render_reference`` is the plain torch version: it follows the JAX
``render`` operation for operation (same ``_data_to_px`` form, same paint
order, same ``1e-12`` guards), so Python floats stay Python floats and
tensors are float32 exactly where the JAX version has them. ``render`` is
the public entry: a CUDA tensor goes to the hand-written kernel
(``renderer_cuda.py``), which launches or raises; a CPU tensor goes to
``render_reference``.
"""
from __future__ import annotations

import torch

# matplotlib default axes rect of a borderless single-axes figure
_AX_X0, _AX_Y0, _AX_W, _AX_H = 0.125, 0.11, 0.775, 0.77
_XLIM = (0.0, 20.0)
_YLIM = (-2.0, 22.0)
_LINEWIDTH_PT = 3.0  # points; figure is 1 inch => fraction lw/72 of the image

_WHITE = (1.0, 1.0, 1.0)
_ORANGE = (1.0, 165 / 255.0, 0.0)
_FIREBRICK = (178 / 255.0, 34 / 255.0, 34 / 255.0)
_BLACK = (0.0, 0.0, 0.0)
_BLUE = (0.0, 0.0, 1.0)

CENTER = (10.0, 10.5)  # pendulum axis
ROD_LEN = 9.5          # incl. ball
GROUND = -0.5          # shadow plane offset


def _data_to_px(x, y, size):
    """Data coords -> pixel coords (px right, py down)."""
    fx = _AX_X0 + _AX_W * (x - _XLIM[0]) / (_XLIM[1] - _XLIM[0])
    fy = _AX_Y0 + _AX_H * (y - _YLIM[0]) / (_YLIM[1] - _YLIM[0])
    return fx * size, (1.0 - fy) * size


def _scales(size):
    sx = _AX_W * size / (_XLIM[1] - _XLIM[0])
    sy = _AX_H * size / (_YLIM[1] - _YLIM[0])
    return sx, sy


def _f32_sqrt(v: float) -> float:
    """sqrt taken in float32, as ``jnp.sqrt`` of a Python float is."""
    return float(torch.sqrt(torch.tensor(v, dtype=torch.float32)))


def _coverage(dist_px):
    return torch.clamp(0.5 - dist_px, 0.0, 1.0)


def _ellipse_distance(px, py, cx, cy, r, size):
    """Approximate signed pixel distance to a data-space circle."""
    sx, sy = _scales(size)
    ccx, ccy = _data_to_px(cx, cy, size)
    dx, dy = px - ccx, py - ccy
    rho = torch.sqrt((dx / (r * sx)) ** 2 + (dy / (r * sy)) ** 2 + 1e-12)
    return (rho - 1.0) * r * _f32_sqrt(sx * sy)


def _segment_distance(px, py, ax, ay, bx, by, size):
    """Exact pixel distance to a data-space segment."""
    pax, pay = _data_to_px(ax, ay, size)
    pbx, pby = _data_to_px(bx, by, size)
    vx, vy = pbx - pax, pby - pay
    wx, wy = px - pax, py - pay
    t = torch.clamp((wx * vx + wy * vy) / (vx * vx + vy * vy + 1e-12),
                    0.0, 1.0)
    dx, dy = wx - t * vx, wy - t * vy
    return torch.sqrt(dx * dx + dy * dy + 1e-12)


def _paint(img, cov, color):
    return img * (1.0 - cov[..., None]) + color * cov[..., None]


def _scene(factors: torch.Tensor):
    """Per-image scalars of float32 factors [batch, 4], each [batch]:
    (light_x, ball_x, ball_y, xi3, xi4) in data coordinates."""
    xi1, xi2, xi3, xi4 = factors.unbind(1)
    light_x = CENTER[0] + 10.0 / torch.tan(xi1)
    ball_x = CENTER[0] + (ROD_LEN - 1.5) * torch.sin(xi2)
    ball_y = CENTER[1] - (ROD_LEN - 1.5) * torch.cos(xi2)
    return light_x, ball_x, ball_y, xi3, xi4


def _pixel_range(lo, hi, size):
    """Half-open index range [i0, i1) of the pixels whose centre i + 0.5
    lies in (lo - 1, hi + 1), clamped to [0, size]: the open interval
    (lo, hi) plus one whole pixel of margin against float32 rounding."""
    i0 = torch.floor(lo - 1.5) + 1
    i1 = torch.ceil(hi + 0.5)
    return (i0.clamp(0, size).to(torch.int64),
            i1.clamp(0, size).to(torch.int64))


def shape_boxes(factors: torch.Tensor, size: int = 64) -> torch.Tensor:
    """Conservative pixel boxes of the four shapes, [batch, 4, 4] int64.

    Row k of an image is shape k in paint order (sun, rod, ball, shadow)
    as (x0, x1, y0, y1), half-open and clamped to the image and to the
    axes window. Outside its box a shape's painted coverage
    ``window * clip(0.5 - d, 0, 1)`` is exactly 0, so a renderer may skip
    it there without changing a bit. The support is the ellipse's extent
    plus its fringe, ``r*sx + 0.5*sqrt(sx/sy)`` across and
    ``r*sy + 0.5*sqrt(sy/sx)`` down (where d = 0.5), or the segment's
    bounding box widened by ``lw_half + 0.5``. ``csrc/render.cu`` carries
    the same formula; this copy is what the CPU tests check.
    """
    factors = factors.to(torch.float32)
    light_x, ball_x, ball_y, xi3, xi4 = _scene(factors)
    sx, sy = _scales(size)
    seg = 0.5 * _LINEWIDTH_PT / 72.0 * size + 0.5

    x0, y1 = _data_to_px(_XLIM[0], _YLIM[0], size)
    x1, y0 = _data_to_px(_XLIM[1], _YLIM[1], size)
    # pixels where the window factor is > 0: centre in (x0-0.5, x1+0.5)
    win = (_pixel_range(torch.tensor(x0 - 0.5), torch.tensor(x1 + 0.5), size)
           + _pixel_range(torch.tensor(y0 - 0.5), torch.tensor(y1 + 0.5),
                          size))

    def ellipse(cx, cy, r):
        hx = r * sx + 0.5 * (sx / sy) ** 0.5
        hy = r * sy + 0.5 * (sy / sx) ** 0.5
        return (cx - hx, cx + hx, cy - hy, cy + hy)

    def segment(ax, ay, bx, by):
        return (torch.minimum(ax, bx) - seg, torch.maximum(ax, bx) + seg,
                torch.minimum(ay, by) - seg, torch.maximum(ay, by) + seg)

    sun_x, sun_y = _data_to_px(light_x, 20.5, size)
    sun_y = torch.full_like(sun_x, sun_y)
    ball_px, ball_py = _data_to_px(ball_x, ball_y, size)
    piv_x, piv_y = _data_to_px(CENTER[0], CENTER[1], size)
    sha_x, ground = _data_to_px(xi4 - xi3 / 2.0, GROUND, size)
    shb_x, _ = _data_to_px(xi4 + xi3 / 2.0, GROUND, size)
    ground = torch.full_like(sha_x, ground)
    supports = [ellipse(sun_x, sun_y, 3.0),
                segment(torch.full_like(ball_px, piv_x),
                        torch.full_like(ball_py, piv_y), ball_px, ball_py),
                ellipse(ball_px, ball_py, 1.5),
                segment(sha_x, ground, shb_x, ground)]
    boxes = []
    for lx, hx, ly, hy in supports:
        bx0, bx1 = _pixel_range(lx, hx, size)
        by0, by1 = _pixel_range(ly, hy, size)
        boxes.append(torch.stack([bx0.clamp(min=win[0]), bx1.clamp(max=win[1]),
                                  by0.clamp(min=win[2]), by1.clamp(max=win[3])],
                                 1))
    return torch.stack(boxes, 1)


def render_reference(factors: torch.Tensor, size: int = 64,
                     background: torch.Tensor | None = None) -> torch.Tensor:
    """Render a batch of pendulum scenes with plain torch ops.

    factors: [batch, 4] float32 = (light_angle, pendulum_angle,
    shadow_length, shadow_position). background: optional [batch] 0/1, the
    DR family's spurious attribute (1 paints the axes window blue).
    Returns [batch, size, size, 3] float32 in [-1, 1], channels-last.
    """
    dev = factors.device
    factors = factors.to(torch.float32)
    if background is None:
        background = torch.zeros(factors.shape[0], dtype=torch.float32,
                                 device=dev)
    background = background.to(device=dev, dtype=torch.float32)
    window, shapes = _painted_coverages(factors, size)

    def color(c):
        return torch.tensor(c, dtype=torch.float32, device=dev)

    img = color(_WHITE).expand(factors.shape[0], size, size, 3)
    img = _paint(img, window * (background[:, None, None] > 0.5),
                 color(_BLUE))
    for cov, c in zip(shapes, (_ORANGE, _BLACK, _FIREBRICK, _BLACK)):
        img = _paint(img, cov, color(c))
    return img * 2.0 - 1.0


def _painted_coverages(factors: torch.Tensor, size: int):
    """The axes-window factor [size, size] and, in paint order (sun, rod,
    ball, shadow), each shape's painted coverage ``window * clip(0.5 - d,
    0, 1)`` [batch, size, size] of float32 factors [batch, 4]."""
    light_x, ball_x, ball_y, xi3, xi4 = (v[:, None, None]
                                         for v in _scene(factors))
    coords = torch.arange(size, dtype=torch.float32,
                          device=factors.device) + 0.5
    py = coords[:, None].expand(size, size)
    px = coords[None, :].expand(size, size)

    lw_half = 0.5 * _LINEWIDTH_PT / 72.0 * size  # line half-width in px

    x0, y1 = _data_to_px(_XLIM[0], _YLIM[0], size)
    x1, y0 = _data_to_px(_XLIM[1], _YLIM[1], size)
    window = (torch.clamp(torch.minimum(px - x0, x1 - px) + 0.5, 0.0, 1.0)
              * torch.clamp(torch.minimum(py - y0, y1 - py) + 0.5, 0.0, 1.0))
    sun = _ellipse_distance(px, py, light_x, 20.5, 3.0, size)
    rod = _segment_distance(px, py, CENTER[0], CENTER[1], ball_x, ball_y,
                            size)
    ball = _ellipse_distance(px, py, ball_x, ball_y, 1.5, size)
    shadow = _segment_distance(px, py, xi4 - xi3 / 2.0, GROUND,
                               xi4 + xi3 / 2.0, GROUND, size)
    return window, [window * _coverage(sun), window * _coverage(rod - lw_half),
                    window * _coverage(ball),
                    window * _coverage(shadow - lw_half)]


def render(factors: torch.Tensor, size: int = 64,
           background: torch.Tensor | None = None, *,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """Render on the tensor's device: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor. ``out``, if given, is a contiguous
    float32 [B, size, size, 3] tensor that receives the images and is
    returned."""
    if factors.device.type == "cuda":
        from .renderer_cuda import render_cuda
        return render_cuda(factors, size, background, out=out)
    if factors.device.type == "cpu":
        img = render_reference(factors, size, background)
        return img if out is None else out.copy_(img)
    raise ValueError(f"render: unsupported device {factors.device}")
