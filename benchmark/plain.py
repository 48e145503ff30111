"""Plain PyTorch pieces that the configurations' references share.

Nothing here imports the program under test: the references work out
again, from the seed and the inputs, what the program computes, and only
read the program's outputs to judge them.

* :func:`derived_seed`: the seeds of the derived generators that the
  program's epoch and online drivers draw from (numpy's
  ``SeedSequence`` over the run's seed and a path), so a reference draws
  the same permutations and noise on the same device.
* :func:`make_weights`: a model's initial weights from the seed, on the
  device, in a few large draws: one uniform and one normal draw over all
  leaves, each leaf a view scaled by its own bounds. Both the program and
  the reference start from them.
* :class:`Numerics`: the matrix products and convolutions of a reference,
  in float32, or with their operands rounded to TF32, forward and
  backward: the control that must fail the comparison.
* :func:`readings`: what the comparison reads of a run's first steps.
* :func:`adam`: Adam's update as optax computes it, in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# the program's streams of derived generators
EPOCH, ONLINE_STEP = 0, 1


def derived_seed(seed: int, *path: int) -> int:
    """A 64-bit seed from ``seed`` and every entry of ``path``."""
    state = np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)
    return int(state[0])


def derived_generator(seed: int, *path: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, *path))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def make_weights(specs, seed: int, device) -> dict:
    """``specs``: ``(name, shape, kind, a, b)`` with ``kind`` "uniform"
    (U(a, b)), "normal" (N(0, a^2)), "zeros" or "ones". Returns {name:
    float32 tensor on ``device``}, drawn from a generator seeded with
    ``seed`` on ``device``: all uniforms in one draw, then all normals in
    one draw, in ``specs`` order."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for kind in ("uniform", "normal"):
        group = [s for s in specs if s[2] == kind]
        sizes = [math.prod(s[1]) for s in group]
        if not group:
            continue
        n = sum(sizes)
        if kind == "uniform":
            flat = torch.rand(n, generator=g, device=device)
            lo = torch.tensor([s[3] for s in group], device=device)
            width = torch.tensor([s[4] - s[3] for s in group], device=device)
            reps = torch.tensor(sizes, device=device)
            flat = flat * width.repeat_interleave(reps) \
                + lo.repeat_interleave(reps)
        else:
            flat = torch.randn(n, generator=g, device=device)
            std = torch.tensor([s[3] for s in group], device=device)
            flat = flat * std.repeat_interleave(torch.tensor(sizes,
                                                             device=device))
        for s, piece in zip(group, flat.split(sizes)):
            out[s[0]] = piece.view(s[1])
    for name, shape, kind, _, _ in specs:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind not in ("uniform", "normal"):
            raise ValueError(f"unknown init kind {kind!r} of {name}")
    return {name: out[name] for name, *_ in specs}


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest (ties away),
    as the tensor cores round an operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundedMM(torch.autograd.Function):
    """``a @ b`` (matmul's broadcasting) with every operand of the forward
    and of the two backward products rounded."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, grad):
        ra, rb = ctx.saved_tensors
        g = ctx.rnd(grad)
        ga = g @ rb.transpose(-1, -2)
        gb = ra.transpose(-1, -2) @ g
        # undo matmul's broadcasting of a batched operand
        while ga.ndim > ra.ndim:
            ga = ga.sum(0)
        while gb.ndim > rb.ndim:
            gb = gb.sum(0)
        return ga, gb, None


class _RoundedConv(torch.autograd.Function):
    """``conv2d(x, w)`` (no bias) with the operands of the forward and of
    both backward convolutions rounded."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, rnd):
        rx, rw = rnd(x), rnd(w)
        ctx.save_for_backward(rx, rw)
        ctx.conf = (stride, padding, rnd)
        return F.conv2d(rx, rw, None, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        rx, rw = ctx.saved_tensors
        stride, padding, rnd = ctx.conf
        g = rnd(grad.contiguous())
        gx = torch.nn.grad.conv2d_input(rx.shape, rw, g, stride, padding)
        gw = torch.nn.grad.conv2d_weight(rx, rw.shape, g, stride, padding)
        return gx, gw, None, None, None


class Numerics:
    """The products of a reference: plain float32, or with their operands
    rounded to TF32 (``tf32``)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a, b):
        if not self.tf32:
            return a @ b
        return _RoundedMM.apply(a, b, round_tf32)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        """``w`` OIHW; ``stride`` and ``padding`` the same on both axes."""
        if not self.tf32:
            return F.conv2d(x, w, b, stride, padding)
        out = _RoundedConv.apply(x, w, (stride, stride), (padding, padding),
                                 round_tf32)
        return out if b is None else out + b.view(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# losses and the optimizer
# ---------------------------------------------------------------------------

def kl_std_normal(mean, logvar):
    return 0.5 * (mean ** 2 - logvar + torch.exp(logvar) - 1.0).sum(1).mean()


def alignment_bce(z, y):
    """BCE with logits summed over nodes, batch mean, in the stable form."""
    bce = torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return bce.sum(1).mean()


def adam(params: dict, grads: dict, state: dict, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step in place (optax's ``adam``: bias-corrected moments,
    ``eps`` outside the square root), float32; ``state`` holds ``t`` and
    the moments ``m``, ``v`` by name."""
    t = state["t"] = state.get("t", 0) + 1
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m = state.setdefault(("m", name), torch.zeros_like(p))
            v = state.setdefault(("v", name), torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))


def norms(tensors: dict) -> dict:
    """{name: the float64 norm of the tensor, a 0-d tensor on its device}
    (no sync with the host)."""
    return {k: torch.linalg.vector_norm(v.detach().double())
            for k, v in tensors.items()}


def readings(losses, grads, change: dict, sn_change: dict) -> dict:
    """What the comparison reads of a run's first steps, as Python floats:
    each step's loss; by leaf, the norm of each step's gradient (``grads``,
    a dict a step) and of the change of the parameters over the steps; by
    spectral-norm state (a site's ``u`` or ``v``), the norm of its change
    (empty where the model has none). Each dict holds tensors or their
    norms (:func:`norms`)."""
    def floats(d):
        return {k: float(torch.linalg.vector_norm(v.detach().double()))
                for k, v in d.items()}
    return {"loss": [float(v) for v in losses],
            "grads": [floats(g) for g in grads],
            "change": floats(change), "sn_change": floats(sn_change)}
