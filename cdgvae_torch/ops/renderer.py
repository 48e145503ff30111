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

    def col(v):  # per-image scalar -> [batch, 1, 1]
        return v[:, None, None]

    xi1, xi2, xi3, xi4 = (col(factors[:, i]) for i in range(4))
    light_x = CENTER[0] + 10.0 / torch.tan(xi1)
    ball_x = CENTER[0] + (ROD_LEN - 1.5) * torch.sin(xi2)
    ball_y = CENTER[1] - (ROD_LEN - 1.5) * torch.cos(xi2)
    bg = col(background)

    coords = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    py = coords[:, None].expand(size, size)
    px = coords[None, :].expand(size, size)

    lw_half = 0.5 * _LINEWIDTH_PT / 72.0 * size  # line half-width in px

    x0, y1 = _data_to_px(_XLIM[0], _YLIM[0], size)
    x1, y0 = _data_to_px(_XLIM[1], _YLIM[1], size)
    window = (torch.clamp(torch.minimum(px - x0, x1 - px) + 0.5, 0.0, 1.0)
              * torch.clamp(torch.minimum(py - y0, y1 - py) + 0.5, 0.0, 1.0))

    def color(c):
        return torch.tensor(c, dtype=torch.float32, device=dev)

    img = color(_WHITE).expand(factors.shape[0], size, size, 3)
    img = _paint(img, window * (bg > 0.5), color(_BLUE))
    # sun
    d = _ellipse_distance(px, py, light_x, 20.5, 3.0, size)
    img = _paint(img, window * _coverage(d), color(_ORANGE))
    # rod
    d = _segment_distance(px, py, CENTER[0], CENTER[1], ball_x, ball_y, size)
    img = _paint(img, window * _coverage(d - lw_half), color(_BLACK))
    # ball
    d = _ellipse_distance(px, py, ball_x, ball_y, 1.5, size)
    img = _paint(img, window * _coverage(d), color(_FIREBRICK))
    # shadow
    d = _segment_distance(px, py, xi4 - xi3 / 2.0, GROUND,
                          xi4 + xi3 / 2.0, GROUND, size)
    img = _paint(img, window * _coverage(d - lw_half), color(_BLACK))
    return img * 2.0 - 1.0


def render(factors: torch.Tensor, size: int = 64,
           background: torch.Tensor | None = None) -> torch.Tensor:
    """Render on the tensor's device: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if factors.device.type == "cuda":
        from .renderer_cuda import render_cuda
        return render_cuda(factors, size, background)
    if factors.device.type == "cpu":
        return render_reference(factors, size, background)
    raise ValueError(f"render: unsupported device {factors.device}")
