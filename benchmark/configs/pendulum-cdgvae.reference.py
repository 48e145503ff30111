"""The plain reference of the pendulum CDG-VAE's training step.

A frozen, plain float32 copy of what one supervised training step of the
pendulum CDG-VAE computes (the reference's ``main.py:93-107``): the
pendulum_real data-generating process (numpy for the rendered dataset,
the device draws for online training), the analytic rasteriser, the MLP
encoder, the linear SEM solve and affine flows, the band-sliced GAM
decoder, the ELBO with the alignment loss, and Adam. It imports nothing
of the program under test.

:func:`run` follows the first steps of a run from the weights the
benchmark made (:func:`weight_specs`) and the seed: it draws the epoch's
permutation or each online batch and each step's noise from the same
derived generators the program's drivers use, so it trains on the same
rows with the same noise, and returns the readings the comparison reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import plain

# ---------------------------------------------------------------------------
# the scene and its rasteriser (float32, analytic 1-px coverage)
# ---------------------------------------------------------------------------

_AX_X0, _AX_Y0, _AX_W, _AX_H = 0.125, 0.11, 0.775, 0.77
_XLIM, _YLIM = (0.0, 20.0), (-2.0, 22.0)
_LINEWIDTH_PT = 3.0
_WHITE, _BLACK = (1.0, 1.0, 1.0), (0.0, 0.0, 0.0)
_ORANGE = (1.0, 165 / 255.0, 0.0)
_FIREBRICK = (178 / 255.0, 34 / 255.0, 34 / 255.0)
CENTER, ROD_LEN, GROUND = (10.0, 10.5), 9.5, -0.5
_BETA = (1.0, -1.0, 0.5, -0.5)


def _data_to_px(x, y, size):
    fx = _AX_X0 + _AX_W * (x - _XLIM[0]) / (_XLIM[1] - _XLIM[0])
    fy = _AX_Y0 + _AX_H * (y - _YLIM[0]) / (_YLIM[1] - _YLIM[0])
    return fx * size, (1.0 - fy) * size


def _scales(size):
    return (_AX_W * size / (_XLIM[1] - _XLIM[0]),
            _AX_H * size / (_YLIM[1] - _YLIM[0]))


def _coverage(d):
    return torch.clamp(0.5 - d, 0.0, 1.0)


def _ellipse_distance(px, py, cx, cy, r, size):
    sx, sy = _scales(size)
    ccx, ccy = _data_to_px(cx, cy, size)
    dx, dy = px - ccx, py - ccy
    rho = torch.sqrt((dx / (r * sx)) ** 2 + (dy / (r * sy)) ** 2 + 1e-12)
    root = float(torch.sqrt(torch.tensor(sx * sy, dtype=torch.float32)))
    return (rho - 1.0) * r * root


def _segment_distance(px, py, ax, ay, bx, by, size):
    pax, pay = _data_to_px(ax, ay, size)
    pbx, pby = _data_to_px(bx, by, size)
    vx, vy = pbx - pax, pby - pay
    wx, wy = px - pax, py - pay
    t = torch.clamp((wx * vx + wy * vy) / (vx * vx + vy * vy + 1e-12),
                    0.0, 1.0)
    dx, dy = wx - t * vx, wy - t * vy
    return torch.sqrt(dx * dx + dy * dy + 1e-12)


def render(factors: torch.Tensor, size: int) -> torch.Tensor:
    """[n, 4] float32 (light, angle, shadow length, shadow position) ->
    [n, size, size, 3] in [-1, 1]: sun, rod, ball and shadow painted over
    white in that order, clipped to the axes window."""
    dev = factors.device
    xi1, xi2, xi3, xi4 = (v[:, None, None] for v in factors.unbind(1))
    light_x = CENTER[0] + 10.0 / torch.tan(xi1)
    ball_x = CENTER[0] + (ROD_LEN - 1.5) * torch.sin(xi2)
    ball_y = CENTER[1] - (ROD_LEN - 1.5) * torch.cos(xi2)
    coords = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    py = coords[:, None].expand(size, size)
    px = coords[None, :].expand(size, size)
    lw_half = 0.5 * _LINEWIDTH_PT / 72.0 * size
    x0, y1 = _data_to_px(_XLIM[0], _YLIM[0], size)
    x1, y0 = _data_to_px(_XLIM[1], _YLIM[1], size)
    window = (torch.clamp(torch.minimum(px - x0, x1 - px) + 0.5, 0.0, 1.0)
              * torch.clamp(torch.minimum(py - y0, y1 - py) + 0.5, 0.0, 1.0))
    covs = [
        window * _coverage(_ellipse_distance(px, py, light_x, 20.5, 3.0,
                                             size)),
        window * _coverage(_segment_distance(px, py, CENTER[0], CENTER[1],
                                             ball_x, ball_y, size)
                           - lw_half),
        window * _coverage(_ellipse_distance(px, py, ball_x, ball_y, 1.5,
                                             size)),
        window * _coverage(_segment_distance(px, py, xi4 - xi3 / 2.0, GROUND,
                                             xi4 + xi3 / 2.0, GROUND, size)
                           - lw_half)]
    img = torch.tensor(_WHITE, device=dev).expand(factors.shape[0], size,
                                                  size, 3)
    for cov, c in zip(covs, (_ORANGE, _BLACK, _FIREBRICK, _BLACK)):
        color = torch.tensor(c, dtype=torch.float32, device=dev)
        img = img * (1.0 - cov[..., None]) + color * cov[..., None]
    return img * 2.0 - 1.0


# ---------------------------------------------------------------------------
# the data-generating process
# ---------------------------------------------------------------------------

def _physics(light, angle, xp):
    cx, cy = CENTER
    tip_x = cx + ROD_LEN * xp.sin(angle)
    tip_y = cy - ROD_LEN * xp.cos(angle)
    t = xp.tan(light)
    right = tip_x - (tip_y - GROUND) / t
    left = cx - (cy - GROUND) / t
    return right - left, (right + left) / 2.0


def host_factors(seed: int, n: int):
    """The numpy DGP: (factors [n, 5] rounded to 4 decimals, is_test [n])."""
    rng = np.random.RandomState(seed)
    light = rng.uniform(math.pi / 4, math.pi / 2, n)
    angle = rng.uniform(0, math.pi / 4, n)
    length, position = _physics(light, angle, np)
    length = length + rng.normal(0, 0.1, n)
    position = position + rng.normal(0, 0.1, n)
    corrupt = (np.arange(n) + 1) % 5 == 0
    length = np.where(corrupt, rng.uniform(0, 12, n), length)
    position = np.where(corrupt, rng.uniform(0, 12, n), position)
    logit = np.stack([light, angle, length, position], 1) @ np.array(_BETA)
    p = 1.0 / (1.0 + np.exp(-logit + 2.0 * np.sin(logit)))
    target = rng.binomial(1, p).astype(np.float64)
    factors = np.round(np.stack([light, angle, length, position, target],
                                1), 4)
    return factors, (np.arange(n) + 1) % 4 == 0


def fixed_split(seed: int, n: int):
    """The rendered dataset's train split: (factors [m, 4] float32, labels
    [m, 5] float32), the labels centred then min-max scaled."""
    factors, is_test = host_factors(seed, n)
    train = factors[~is_test]
    label = train - train.mean(axis=0)
    label = (label - label.min(axis=0)) / (label.max(axis=0)
                                          - label.min(axis=0))
    return train[:, :4].astype(np.float32), label.astype(np.float32)


# each device draw of an online batch, in the generator's order: the shape
# after the rows, and the uniform's range or None for a standard normal
_DRAWS = (((), (math.pi / 4, math.pi / 2)), ((), (0.0, math.pi / 4)),
          ((), None), ((), None), ((2,), (0.0, 12.0)), ((), (0.0, 1.0)))


def online_batch(g: torch.Generator, n: int, norm, size: int):
    """One online batch of ``n`` rows from ``g``: (images, labels)."""
    draws = []
    for shape, bounds in _DRAWS:
        buf = torch.empty((n, *shape), device=g.device)
        if bounds is None:
            buf.normal_(generator=g)
        elif bounds == (0.0, 1.0):
            buf.uniform_(generator=g)
        else:
            lo, hi = bounds
            buf.uniform_(generator=g).mul_(hi - lo).add_(lo)
        draws.append(buf)
    light, angle, ln, pn, resample, target_u = draws
    length, position = _physics(light, angle, torch)
    length = length + 0.1 * ln
    position = position + 0.1 * pn
    corrupt = (torch.arange(n, device=g.device) + 1) % 5 == 0
    length = torch.where(corrupt, resample[:, 0], length)
    position = torch.where(corrupt, resample[:, 1], position)
    f4 = (light, angle, length, position)
    logit = sum(f * b for f, b in zip(f4, _BETA))
    p = 1.0 / (1.0 + torch.exp(-logit + 2.0 * torch.sin(logit)))
    factors = torch.stack([*f4, (target_u < p).float()], 1)
    mu, mn, mx = norm
    return render(factors[:, :4].contiguous(), size), \
        ((factors - mu) - mn) / (mx - mn)


def online_norm(seed: int, n: int, device):
    """The frozen label constants of online training: the host DGP's
    train-split mean and centred min and max."""
    factors, is_test = host_factors(seed, n)
    train = factors[~is_test]
    centred = train - train.mean(axis=0)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (train.mean(axis=0), centred.min(axis=0),
                           centred.max(axis=0)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def bands(size: int):
    """The decoder blocks' flat output ranges: rows [0, 20), [20, 51),
    [51, 64) of the 64 px image."""
    if size != 64:
        raise ValueError("the reference's decoder bands are the 64 px ones")
    rows = [0, 20, 51, 64]
    return [(rows[i] * size * 3, rows[i + 1] * size * 3) for i in range(3)]


def blocks(cfg) -> list:
    out, start = [], 0
    for k in cfg["factor"]:
        out.append(list(range(start, start + k)))
        start += k
    return out


def weight_specs(cfg) -> list:
    """The trained leaves, with the distributions they start from: dense
    layers U(+-1/sqrt(fan_in)), the flows' ``p`` U(0, 0.1)."""
    s, hid, node = cfg["image_size"], cfg["hidden"], cfg["node"]
    d, k = 3 * s * s, len(cfg["factor"])
    kmax = max(cfg["factor"])
    specs = []

    def dense(name, fan_in, wshape, bshape):
        bound = 1.0 / math.sqrt(fan_in)
        specs.append((name + ".w", wshape, "uniform", -bound, bound))
        specs.append((name + ".b", bshape, "uniform", -bound, bound))

    for i, (a, b) in enumerate([(d, hid), (hid, hid), (hid, 2 * node)]):
        dense(f"encoder.layer{i}", a, (a, b), (b,))
    specs.append(("causal.flows.p", (node, 2), "uniform", 0.0, 0.1))
    dense("decoder.layer0", kmax, (k, kmax, hid), (k, 1, hid))
    dense("decoder.layer1", hid, (k, hid, hid), (k, 1, hid))
    for i, (c0, c1) in enumerate(bands(s)):
        bound = 1.0 / math.sqrt(hid)
        specs.append((f"decoder.out.w{i}", (hid, c1 - c0), "uniform",
                      -bound, bound))
        specs.append((f"decoder.out.b{i}", (c1 - c0,), "uniform", -bound,
                      bound))
    return specs


def i_b_inv(cfg, device) -> torch.Tensor:
    """(I - B)^-1 of the pendulum graph (light, angle -> length,
    position), B's columns scaled by their in-degree, solved in float64."""
    node = cfg["node"]
    B = np.zeros((node, node))
    B[0, 2] = B[0, 3] = B[1, 2] = B[1, 3] = 1.0
    deg = B.sum(axis=0)
    B[:, deg > 0] /= deg[deg > 0]
    return torch.as_tensor(np.linalg.inv(np.eye(node) - B),
                           dtype=torch.float32, device=device)


def loss(P: dict, x, y, noise, cfg, ibinv, Q: plain.Numerics):
    """The step's loss: 0.5 sum of squares + beta KL + lambda alignment."""
    n, node = x.shape[0], cfg["node"]
    h = x.reshape(n, -1)
    for i in range(3):
        h = Q.mm(h, P[f"encoder.layer{i}.w"]) + P[f"encoder.layer{i}.b"]
        if i < 2:
            h = F.elu(h)
    mean, logvar = h[:, :node], h[:, node:]
    eps = mean + torch.exp(logvar / 2.0) * noise
    p = P["causal.flows.p"]
    z = p[:, 0] * Q.mm(eps, ibinv) + p[:, 1]
    kmax = max(cfg["factor"])
    h = torch.stack([F.pad(z[:, idx], (0, kmax - len(idx)))
                     for idx in blocks(cfg)])
    for i in range(2):
        h = F.elu(Q.mm(h, P[f"decoder.layer{i}.w"])
                  + P[f"decoder.layer{i}.b"])
    flat = torch.cat([Q.mm(h[k], P[f"decoder.out.w{k}"])
                      + P[f"decoder.out.b{k}"]
                      for k in range(len(cfg["factor"]))], 1)
    xhat = torch.tanh(flat).reshape(x.shape)
    align = p[:, 0] * Q.mm(mean, ibinv) + p[:, 1]
    recon = 0.5 * ((xhat - x) ** 2).sum(dim=(1, 2, 3)).mean()
    return recon + cfg["beta"] * plain.kl_std_normal(mean, logvar) \
        + cfg["lambda"] * plain.alignment_bce(align, y[:, :node])


def batches(cfg, feed: str, seed: int, steps: int, device):
    """Each of the first ``steps`` steps' (x, y, noise), drawn as the
    program's epoch runner (``feed`` "fixed") or online trainer
    ("online") draws them."""
    bs, node, size = cfg["batch_size"], cfg["node"], cfg["image_size"]
    if feed == "fixed":
        f4, labels = fixed_split(seed, cfg["n_samples"])
        g = plain.derived_generator(seed, plain.EPOCH, 0, device=device)
        perm = torch.randperm(len(f4), generator=g, device=device)
        for k in range(steps):
            rows = perm[k * bs:(k + 1) * bs].cpu().numpy()
            x = render(torch.as_tensor(f4[rows], device=device), size)
            y = torch.as_tensor(labels[rows], device=device)
            yield x, y, torch.empty(bs, node, device=device).normal_(
                generator=g)
        return
    norm = online_norm(seed, cfg["n_samples"], device)
    g = torch.Generator(device=device)
    for k in range(steps):
        g.manual_seed(plain.derived_seed(seed, plain.ONLINE_STEP, k))
        x, y = online_batch(g, bs, norm, size)
        yield x, y, torch.empty(bs, node, device=device).normal_(generator=g)


def run(cfg, traffic, seed: int, weights: dict, device, tf32=False,
        steps: int = 3, half_batch: bool = False) -> dict:
    """The first ``steps`` training steps from ``weights``: their
    readings (:func:`benchmark.plain.readings`).
    ``tf32`` rounds the products' operands (the control); ``half_batch``
    takes each loss over the first half of the batch alone (a fault)."""
    Q = plain.Numerics(tf32)
    ibinv = i_b_inv(cfg, device)
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.items()}
    state, losses, grads = {}, [], []
    for x, y, noise in batches(cfg, traffic["feed"], seed, steps, device):
        if half_batch:
            half = x.shape[0] // 2
            x, y, noise = x[:half], y[:half], noise[:half]
        value = loss(P, x, y, noise, cfg, ibinv, Q)
        grads.append(dict(zip(P, torch.autograd.grad(value,
                                                     list(P.values())))))
        plain.adam(P, grads[-1], state, cfg["lr"])
        losses.append(value.detach())
    return plain.readings(losses, grads,
                          {k: P[k].detach() - weights[k] for k in P}, {})
