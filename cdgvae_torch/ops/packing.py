"""The packed parameter layout (port of ``cdgvae_tpu/ops/packing.py``).

The JAX package concatenates every small floating leaf of the params tree
into one flat buffer per dtype, so that the TPU stages a few large
buffers instead of hundreds of small ones, and Adam's moments follow the
packed structure. The port keeps the same layout in PyTorch's idiom:

* :class:`Packer` allocates one flat buffer (an ``nn.Parameter``) per
  dtype for the module's small trained floating parameters (at most
  ``max_size`` elements each), each at an offset that is a multiple of
  ``ALIGN`` elements (cuDNN's BatchNorm reads its scale and bias with
  aligned vector loads: a leaf at an odd offset fails with a misaligned
  address on the H100), and makes each of them a view of it: the
  one rebinding of ``.data``, when the packer is built. Whatever writes a
  parameter after that (``utils/interop.py::load_jax_params``,
  ``parallel/mesh.py::replicate``, the optimizer) writes into the view in
  place, so the buffer and the module's parameters stay one storage.
  Larger parameters stay as they are ("big"), and so do the frozen ones
  (a frozen ResNet trunk is not trained), buffers included;
* the optimizer (``train/steps.py::make_optimizer``) steps the flat
  buffers and the big parameters, so Adam keeps one step count and one
  pair of moments a flat buffer;
* the train step (``train/celeba_steps.py``) runs the module on
  :meth:`Packer.unpack`'s views of the flat buffers, whose backward
  writes each buffer's gradient with one ``cat`` (the gaps between the
  leaves, and a leaf the loss does not reach, from one zero buffer); in
  bfloat16 it casts each buffer once before cutting it;
* checkpoints stay canonical: ``utils/interop.py`` reads a small leaf's
  Adam moments as a slice of its buffer's, and writes them back so, so a
  ``state.pkl`` written packed is the one written unpacked.

Adam is elementwise and the views hold the same values, so a packed run
takes the unpacked run's steps bit for bit. The spectral-norm refresh
needs no counterpart of the reference's ``map_unpacked``: it reads the
weights through the module, whose parameters are the views, and writes
its ``u``/``v`` buffers in place.

Build the packer after the module is on its device (a later ``.to()``
would rebind the parameters and end the aliasing).
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

# Leaves with at most this many elements get packed: every bias, BN scale
# and noise weight, while conv kernels and dense matrices (>= 3*3*32*32 =
# 9216) stay separate (the reference's threshold)
DEFAULT_MAX_SIZE = 8192
# each leaf's offset in its buffer, in elements: 64 bytes in float32
ALIGN = 16


class _Unpack(torch.autograd.Function):
    """A flat tensor -> views of its ``spans`` ``(offset, numel, shape)``;
    backward is one ``cat`` of the views' gradients, the gaps and the
    views without a gradient taken from one zero buffer."""

    @staticmethod
    def forward(ctx, flat, spans):
        ctx.spans, ctx.numel = spans, flat.numel()
        ctx.set_materialize_grads(False)
        return tuple(flat[o:o + n].view(shape) for o, n, shape in spans)

    @staticmethod
    def backward(ctx, *grads):
        like = next((g for g in grads if g is not None), None)
        if like is None:
            return None, None
        longest = max(max(n for _, n, _ in ctx.spans), ALIGN)
        zeros = like.new_zeros(longest)
        pieces, at = [], 0
        for (o, n, _), g in zip(ctx.spans, grads):
            if o > at:
                pieces.append(zeros[:o - at])
            pieces.append(zeros[:n] if g is None else g.reshape(-1))
            at = o + n
        if ctx.numel > at:
            pieces.append(zeros[:ctx.numel - at])
        return torch.cat(pieces), None


class Packer:
    """The packed layout of ``module``'s small trained floating
    parameters; see the module docstring.

    ``flats`` maps each dtype to its flat buffer; ``members`` maps it to
    its leaves in buffer order, ``(name, shape, numel, offset)``; ``big``
    is the
    other trained parameters, ``(name, parameter)``, in
    ``named_parameters`` order."""

    def __init__(self, module: nn.Module, max_size: int = DEFAULT_MAX_SIZE):
        small: dict = {}
        self.big: list = []
        for name, p in module.named_parameters():
            if not p.requires_grad:
                continue
            if p.is_floating_point() and p.numel() <= max_size:
                small.setdefault(p.dtype, []).append((name, p))
            else:
                self.big.append((name, p))
        self.flats: dict = {}
        self.members: dict = {}
        with torch.no_grad():
            for dtype, leaves in small.items():
                members, end = [], 0
                for name, p in leaves:
                    offset = -(-end // ALIGN) * ALIGN
                    members.append((name, tuple(p.shape), p.numel(), offset))
                    end = offset + p.numel()
                flat = nn.Parameter(leaves[0][1].new_zeros(end))
                for (_, p), (_, _, n, offset) in zip(leaves, members):
                    flat[offset:offset + n].copy_(p.detach().reshape(-1))
                    p.data = flat.detach()[offset:offset + n].view_as(p)
                self.flats[dtype] = flat
                self.members[dtype] = members
        self.n_small = sum(len(m) for m in self.members.values())
        self.n_big = len(self.big)

    def params(self) -> list:
        """What the optimizer steps: the flat buffers, then the big
        parameters."""
        return list(self.flats.values()) + [p for _, p in self.big]

    def layout(self) -> list:
        """``(optimizer parameter, [(leaf name, shape, numel, offset),
        ...])`` in :meth:`params` order: each flat buffer with its leaves,
        each big parameter with itself at offset 0."""
        return ([(self.flats[d], self.members[d]) for d in self.flats]
                + [(p, [(name, tuple(p.shape), p.numel(), 0)])
                   for name, p in self.big])

    def unpack(self, flats: Mapping | None = None,
               dtype: torch.dtype | None = None) -> dict:
        """{dtype: flat tensor} (by default the parameter buffers) -> {leaf
        name: view of its slice, in the leaf's shape}, each buffer cast to
        ``dtype`` first when given; backward is one ``cat`` a buffer."""
        flats = self.flats if flats is None else flats
        out = {}
        for d, members in self.members.items():
            flat = flats[d] if dtype is None else flats[d].to(dtype)
            views = _Unpack.apply(flat, tuple(
                (offset, n, shape) for _, shape, n, offset in members))
            out.update(zip((m[0] for m in members), views))
        return out
