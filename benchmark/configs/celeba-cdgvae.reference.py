"""The plain reference of the CelebA CDG-VAE's training step.

A frozen, plain float32 copy of one training step of the CelebA CDG-VAE
as the reference's ``celeba/main.py`` trains it: the frozen ResNet-18
trunk with batch-statistics BatchNorm and its linear head, the linear SEM
solve and affine flows over the six causal latents, the five SAGAN
generators (spectral-norm linear and convolutions, BatchNorm, noise
injection, self-attention after the third block, nearest upsampling),
masked and summed under ``tanh``, the L1 ELBO over both latent groups
with the alignment loss, Adam, and one power iteration of every
spectral-norm site after each step. It imports nothing of the program.

Weights are NHWC-era layouts, as the program keeps them: a dense ``w``
[in, out], a convolution ``w`` HWIO, a spectral-norm site's ``u`` [out]
and ``v`` [in-flattened]. Activations here are NCHW.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import plain

BLOCK_GROUPS = ([0, 2], [0, 3], [0, 4], [0, 1, 5])
_WIDTHS = (64, 128, 256, 512)
# the smile structure's edges over (Smiling, Male, High_Cheekbones,
# Mouth_Slightly_Open, Chubby, Narrow_Eyes)
_EDGES = ((0, 2), (0, 3), (0, 4), (0, 5), (1, 5))


def schedule(cfg):
    """The generator's blocks [(in, out)] from 4 px up to ``img_size``
    (32, 64 or 128), and the block the attention follows."""
    cd = cfg["conv_dim"]
    blocks = [(cd * 16, cd * 16), (cd * 16, cd * 8), (cd * 8, cd * 4),
              (cd * 4, cd * 2), (cd * 2, cd)]
    n = {32: 3, 64: 4, 128: 5}[cfg["img_size"]]
    return blocks[:n], 2


def z_dims(cfg):
    return [len(g) for g in BLOCK_GROUPS] + [cfg["latent_dim"]]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def weight_specs(cfg) -> list:
    """Every leaf the step reads, with the distribution it starts from:
    trunk convolutions N(0, 2 / (k k out)), BatchNorm scales 1 and biases
    0, the head U(+-1/sqrt(512)), the flows' ``p`` U(0, 0.1),
    spectral-norm weights N(0, 1/fan_in) with zero biases, noise weights
    and the attention's gate 0, and each site's ``u`` N(0, 1) (``v`` is
    made from it, :func:`sn_start`)."""
    specs = []
    node, ld = cfg["node"], cfg["latent_dim"]

    def conv(name, k, cin, cout):
        specs.append((name + ".w", (k, k, cin, cout), "normal",
                      math.sqrt(2.0 / (k * k * cout)), 0))

    def bn(name, ch):
        specs.append((name + ".scale", (ch,), "ones", 0, 0))
        specs.append((name + ".bias", (ch,), "zeros", 0, 0))

    conv("encoder.stem_conv", 7, 3, 64)
    bn("encoder.stem_bn", 64)
    cin = 64
    for li, width in enumerate(_WIDTHS):
        for bi in range(2):
            p = f"encoder.layer{li}_{bi}"
            conv(p + ".conv1", 3, cin, width)
            bn(p + ".bn1", width)
            conv(p + ".conv2", 3, width, width)
            bn(p + ".bn2", width)
            if cin != width:
                conv(p + ".down_conv", 1, cin, width)
                bn(p + ".down_bn", width)
            cin = width
    bound = 1.0 / math.sqrt(512)
    out = 2 * node + 2 * ld
    specs.append(("encoder.fc.w", (512, out), "uniform", -bound, bound))
    specs.append(("encoder.fc.b", (out,), "uniform", -bound, bound))
    specs.append(("causal.flows.p", (node, 2), "uniform", 0.0, 0.1))

    def sn(name, shape):
        fan_in = math.prod(shape[:-1])
        specs.append((name + ".w", shape, "normal", 1.0 / math.sqrt(fan_in),
                      0))
        specs.append((name + ".b", (shape[-1],), "zeros", 0, 0))
        specs.append((name + ".u", (shape[-1],), "normal", 1.0, 0))
        specs.append((name + ".v", (fan_in,), "zeros", 0, 0))

    blocks, attn_after = schedule(cfg)
    for gi, zd in enumerate(z_dims(cfg)):
        g = f"decoder.gen{gi}"
        c0 = blocks[0][0]
        sn(g + ".block0.linear", (zd, c0 * 16))
        specs.append((g + ".block0.noise.weight", (1, 1, 1, c0), "zeros", 0,
                      0))
        for i, (ci, co) in enumerate(blocks):
            b = f"{g}.block{i + 1}"
            sn(b + ".conv1", (3, 3, ci, co))
            sn(b + ".conv2", (3, 3, co, co))
            sn(b + ".conv0", (1, 1, ci, co))
            bn(b + ".bn1", ci)
            bn(b + ".bn2", co)
            specs.append((b + ".noise1.weight", (1, 1, 1, co), "zeros", 0, 0))
            specs.append((b + ".noise2.weight", (1, 1, 1, co), "zeros", 0, 0))
            if i == attn_after:
                a = g + ".self_attn1"
                sn(a + ".theta", (1, 1, co, co // 8))
                sn(a + ".phi", (1, 1, co, co // 8))
                sn(a + ".g", (1, 1, co, co // 2))
                sn(a + ".attn", (1, 1, co // 2, co))
                specs.append((a + ".sigma", (1,), "zeros", 0, 0))
        final = blocks[-1][1]
        bn(g + ".bn", final)
        sn(g + ".toRGB", (3, 3, final, 3))
    return specs


def _w2d(w):
    """[out, flattened in] of a spectral-norm weight."""
    return w.reshape(-1, w.shape[-1]).T


def power_iteration(w, u, iters: int = 1, Q: plain.Numerics | None = None):
    """``iters`` power iterations of a site's weight from ``u``; (u, v)."""
    Q = Q or plain.Numerics()
    w2d = _w2d(w)
    for _ in range(iters):
        v = Q.mm(w2d.T, u[:, None])[:, 0]
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = Q.mm(w2d, v[:, None])[:, 0]
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    return u, v


@torch.no_grad()
def sn_start(weights: dict) -> dict:
    """Each spectral-norm site's (u, v) after three power iterations from
    its drawn ``u``, in place; returns ``weights``."""
    for name in [k[:-2] for k in weights if k.endswith(".v")]:
        u, v = power_iteration(weights[name + ".w"], weights[name + ".u"], 3)
        weights[name + ".u"].copy_(u)
        weights[name + ".v"].copy_(v)
    return weights


def trained(cfg, name: str) -> bool:
    """Whether a leaf trains: not the frozen trunk (its head trains), not
    a spectral-norm site's ``u``/``v``."""
    if name.endswith((".u", ".v")):
        return False
    return not name.startswith("encoder.") or name.startswith("encoder.fc.")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class _Model:
    def __init__(self, P: dict, cfg, Q: plain.Numerics, ibinv):
        self.P, self.cfg, self.Q, self.ibinv = P, cfg, Q, ibinv

    def conv(self, x, name, stride=1, padding=None, bias=True):
        w = self.P[name + ".w"]
        k = w.shape[0]
        pad = k // 2 if padding is None else padding
        return self.Q.conv2d(x, w.permute(3, 2, 0, 1),
                             self.P[name + ".b"] if bias else None, stride,
                             pad)

    def bn(self, x, name):
        return F.batch_norm(x, None, None, self.P[name + ".scale"],
                            self.P[name + ".bias"], training=True, eps=1e-5)

    def sn_w(self, name):
        w = self.P[name + ".w"]
        u, v = self.P[name + ".u"], self.P[name + ".v"]
        return w / self.Q.mm(self.Q.mm(u[None], _w2d(w)), v[:, None])[0, 0]

    def sn_conv(self, x, name):
        w = self.sn_w(name)
        return self.Q.conv2d(x, w.permute(3, 2, 0, 1), self.P[name + ".b"],
                             1, w.shape[0] // 2)

    def trunk(self, x):
        with torch.no_grad():
            h = F.relu(self.bn(self.conv(x, "encoder.stem_conv", 2,
                                         bias=False), "encoder.stem_bn"))
            h = F.max_pool2d(h, 3, 2, padding=1)
            cin = 64
            for li, width in enumerate(_WIDTHS):
                for bi in range(2):
                    p = f"encoder.layer{li}_{bi}"
                    s = 2 if (li > 0 and bi == 0) else 1
                    y = F.relu(self.bn(self.conv(h, p + ".conv1", s,
                                                 bias=False), p + ".bn1"))
                    y = self.bn(self.conv(y, p + ".conv2", bias=False),
                                p + ".bn2")
                    if cin != width:
                        h = self.bn(self.conv(h, p + ".down_conv", s,
                                              bias=False), p + ".down_bn")
                    h = F.relu(y + h)
                    cin = width
            return h.mean(dim=(2, 3))

    def attention(self, x, a):
        B, C, H, W = x.shape
        Q = self.Q
        theta = self.sn_conv(x, a + ".theta").flatten(2).transpose(1, 2)
        phi = F.max_pool2d(self.sn_conv(x, a + ".phi"), 2).flatten(2)
        attn = torch.softmax(Q.mm(theta, phi), dim=-1)
        g = F.max_pool2d(self.sn_conv(x, a + ".g"), 2).flatten(2) \
            .transpose(1, 2)
        ag = Q.mm(attn, g).transpose(1, 2).reshape(B, C // 2, H, W)
        return x + self.P[a + ".sigma"] * self.sn_conv(ag, a + ".attn")

    def generator(self, gi, z, noise):
        g, P = f"decoder.gen{gi}", self.P
        blocks, attn_after = schedule(self.cfg)
        c0 = blocks[0][0]
        x = self.Q.mm(z, self.sn_w(g + ".block0.linear")) \
            + P[g + ".block0.linear.b"]
        x = x.reshape(z.shape[0], 4, 4, c0).permute(0, 3, 1, 2)
        x = x + P[g + ".block0.noise.weight"].permute(0, 3, 1, 2) \
            * next(noise)
        for i in range(len(blocks)):
            b = f"{g}.block{i + 1}"
            up = F.interpolate(F.relu(self.bn(x, b + ".bn1")),
                               scale_factor=2, mode="nearest")
            h = self.sn_conv(up, b + ".conv1")
            h = h + P[b + ".noise1.weight"].permute(0, 3, 1, 2) * next(noise)
            h = self.sn_conv(F.relu(self.bn(h, b + ".bn2")), b + ".conv2")
            h = h + P[b + ".noise2.weight"].permute(0, 3, 1, 2) * next(noise)
            x = h + self.sn_conv(F.interpolate(x, scale_factor=2,
                                               mode="nearest"), b + ".conv0")
            if i == attn_after:
                x = self.attention(x, g + ".self_attn1")
        return torch.tanh(self.sn_conv(F.relu(self.bn(x, g + ".bn")),
                                       g + ".toRGB"))

    def loss(self, x, y, noise):
        cfg, P, Q = self.cfg, self.P, self.Q
        node, ld = cfg["node"], cfg["latent_dim"]
        rgb = x[..., :3].permute(0, 3, 1, 2)
        h = Q.mm(self.trunk(rgb), P["encoder.fc.w"]) + P["encoder.fc.b"]
        mean1, logvar1 = h[:, :node], h[:, node:2 * node]
        mean2, logvar2 = h[:, 2 * node:2 * node + ld], h[:, 2 * node + ld:]
        eps1 = mean1 + torch.exp(logvar1 / 2.0) * noise[0]
        eps2 = mean2 + torch.exp(logvar2 / 2.0) * noise[1]
        p = P["causal.flows.p"]
        latent = p[:, 0] * Q.mm(eps1, self.ibinv) + p[:, 1]
        sites = iter(noise[2:])
        masks = x[..., 3:].permute(0, 3, 1, 2)
        total = 0.0
        for gi, z in enumerate([latent[:, g] for g in BLOCK_GROUPS]
                               + [eps2]):
            total = total + self.generator(gi, z, sites) \
                * masks[:, gi:gi + 1]
        xhat = torch.tanh(total).permute(0, 2, 3, 1)
        recon = (xhat - (x[..., :3] * 2.0 - 1.0)).abs().sum(
            dim=(1, 2, 3)).mean()
        align = p[:, 0] * Q.mm(mean1, self.ibinv) + p[:, 1]
        kl = plain.kl_std_normal(mean1, logvar1) \
            + plain.kl_std_normal(mean2, logvar2)
        return recon + cfg["beta"] * kl \
            + cfg["lambda"] * plain.alignment_bce(align, y[:, :node])


def i_b_inv(cfg, device) -> torch.Tensor:
    node = cfg["node"]
    B = np.zeros((node, node))
    for a, b in _EDGES:
        B[a, b] = 1.0
    deg = B.sum(axis=0)
    B[:, deg > 0] /= deg[deg > 0]
    return torch.as_tensor(np.linalg.inv(np.eye(node) - B),
                           dtype=torch.float32, device=device)


def noise_shapes(cfg, bs: int) -> list:
    """A step's draws in the program's order: eps1, eps2, then each
    generator's noise sites ([B, 1, side, side]: block0's, then two a
    block)."""
    blocks, _ = schedule(cfg)
    sites = [(bs, 1, 4, 4)] + [(bs, 1, 4 << (i + 1), 4 << (i + 1))
                               for i in range(len(blocks)) for _ in (0, 1)]
    return [(bs, cfg["node"]), (bs, cfg["latent_dim"])] \
        + sites * len(z_dims(cfg))


def run(cfg, traffic, seed: int, weights: dict, data, device, tf32=False,
        steps: int = 3, half_batch: bool = False) -> dict:
    """The first ``steps`` steps on ``data`` (x, y) from ``weights``, each
    followed by one power iteration of every spectral-norm site: the
    epoch's permutation and each step's noise (in the traffic's noise
    dtype, as the program draws it, then float32) from the program's
    derived generator; readings as :func:`benchmark.plain.readings`.
    ``tf32`` rounds the products' operands, the power iterations' too (the
    control); ``half_batch`` takes each loss over the first half of the
    batch (a fault)."""
    x_all, y_all = data
    bs = cfg["batch_size"]
    noise_dtype = getattr(torch, traffic["dtype"])
    ibinv = i_b_inv(cfg, device)
    P = {k: v.detach().clone() for k, v in weights.items()}
    names = [k for k in P if trained(cfg, k)]
    sn = [k for k in P if k.endswith((".u", ".v"))]
    for k in names:
        P[k].requires_grad_(True)
    Q = plain.Numerics(tf32)
    model = _Model(P, cfg, Q, ibinv)
    g = plain.derived_generator(seed, plain.EPOCH, 0, device=device)
    perm = torch.randperm(len(x_all), generator=g, device=device)
    state, losses, grads = {}, [], []
    for k in range(steps):
        rows = perm[k * bs:(k + 1) * bs]
        noise = [torch.empty(s, dtype=noise_dtype, device=device)
                 .normal_(generator=g).float()
                 for s in noise_shapes(cfg, bs)]
        x, y = x_all[rows], y_all[rows]
        if half_batch:
            half = bs // 2
            x, y, noise = x[:half], y[:half], [n[:half] for n in noise]
        value = model.loss(x, y, noise)
        grads.append(dict(zip(names, torch.autograd.grad(
            value, [P[n] for n in names]))))
        plain.adam({n: P[n] for n in names}, grads[-1], state, cfg["lr"])
        with torch.no_grad():
            for site in [n[:-2] for n in sn if n.endswith(".v")]:
                u, v = power_iteration(P[site + ".w"], P[site + ".u"], Q=Q)
                P[site + ".u"].copy_(u)
                P[site + ".v"].copy_(v)
        losses.append(value.detach())
    return plain.readings(losses, grads,
                          {n: P[n].detach() - weights[n] for n in names},
                          {n: P[n] - weights[n] for n in sn})
