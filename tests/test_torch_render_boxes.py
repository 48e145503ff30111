"""The render kernel's culling boxes (``ops/renderer.py::shape_boxes``).

``csrc/render.cu`` skips a shape on every tile its box misses. That is exact
only if the shape's painted coverage ``window * clip(0.5 - d, 0, 1)`` is
exactly 0 outside the box, which these tests check on the CPU with the
plain version's own distance and coverage functions. No JAX here.
"""
import math

import numpy as np
import pytest
import torch

from cdgvae_torch.data import pendulum
from cdgvae_torch.ops.renderer import _painted_coverages, shape_boxes

# a box reaches past the pixels it must hold by at most the pixel grid's
# step plus its one-pixel margin on each side
SLACK_PX = 3


def _edge_factors():
    grid = np.meshgrid([math.pi / 4, math.pi / 2], [0.0, math.pi / 4],
                       [0.0, 13.5], [0.0, 13.5], indexing="ij")
    return np.stack([g.ravel() for g in grid], 1)


FACTOR_SETS = {
    "real": lambda: pendulum.sample_factors_real(seed=1, n=2000)[0][:, :4],
    "grid": lambda: pendulum.grid_factors(30)[0],
    "edge": _edge_factors,
}


@pytest.mark.parametrize("which", sorted(FACTOR_SETS))
@pytest.mark.parametrize("size", [16, 28, 64, 128])
def test_shape_boxes_hold_every_painted_pixel(size, which):
    _check_boxes(FACTOR_SETS[which](), size, chunk=250)


@pytest.mark.parametrize("which", sorted(FACTOR_SETS))
def test_shape_boxes_hold_every_painted_pixel_at_512_px(which):
    """The kernel's largest size (renderer_cuda.MAX_SIZE), on every 40th
    factor set of each kind and every edge set."""
    factors = FACTOR_SETS[which]()
    _check_boxes(factors if which == "edge" else factors[::40], 512, chunk=8)


def _check_boxes(factors, size, chunk):
    factors = torch.as_tensor(factors, dtype=torch.float32)
    idx = torch.arange(size)
    for f in factors.split(chunk):
        boxes = shape_boxes(f, size)
        assert boxes.shape == (len(f), 4, 4) and boxes.dtype == torch.int64
        assert bool(((boxes >= 0) & (boxes <= size)).all())
        _, shapes = _painted_coverages(f, size)
        for k, cov in enumerate(shapes):
            x0, x1, y0, y1 = (boxes[:, k, i, None] for i in range(4))
            in_x = (idx >= x0) & (idx < x1)                  # [b, size]
            in_y = (idx >= y0) & (idx < y1)
            inside = in_y[:, :, None] & in_x[:, None, :]
            painted = cov != 0
            # exactly 0 outside the box: skipping the shape there is exact
            assert not bool((painted & ~inside).any()), f"shape {k}"
            # and the box is tight around what it holds
            cols, rows = painted.any(1), painted.any(2)
            some = cols.any(1)
            first_col = torch.where(cols, idx, size).amin(1)
            last_col = torch.where(cols, idx, -1).amax(1)
            first_row = torch.where(rows, idx, size).amin(1)
            last_row = torch.where(rows, idx, -1).amax(1)
            assert bool((first_col - x0[:, 0] <= SLACK_PX)[some].all())
            assert bool((x1[:, 0] - 1 - last_col <= SLACK_PX)[some].all())
            assert bool((first_row - y0[:, 0] <= SLACK_PX)[some].all())
            assert bool((y1[:, 0] - 1 - last_row <= SLACK_PX)[some].all())


def test_shape_boxes_cut_most_of_the_work():
    """On the pendulum data the boxes meet few 4x8 tiles: the kernel
    evaluates well under one shape a pixel instead of four."""
    factors, is_test = pendulum.sample_factors_real(seed=1, n=4949)
    boxes = shape_boxes(torch.as_tensor(factors[~is_test, :4],
                                        dtype=torch.float32), 64)
    ty, tx = torch.arange(0, 64, 4), torch.arange(0, 64, 8)
    meet_y = (ty < boxes[..., 3:4]) & (ty + 4 > boxes[..., 2:3])
    meet_x = (tx < boxes[..., 1:2]) & (tx + 8 > boxes[..., 0:1])
    meets = meet_y[..., :, None] & meet_x[..., None, :]
    per_pixel = meets.float().mean((0, 2, 3)).sum().item()
    assert per_pixel < 0.5
