"""The CelebA CDG-VAE's loss and train step (port of ``cdgvae_tpu/train/
celeba_steps.py``): L1 reconstruction against the RGB channels rescaled to
[-1, 1], KL over both latent groups, the alignment BCE on the causal
latents, and the ``active`` diagnostic (the share of latents whose mean
posterior variance is under 0.1).

``compute_dtype=torch.bfloat16`` runs the network in bf16 as the JAX
package does: every floating parameter and buffer and the input are cast
(``torch.func.functional_call`` over the cast copies, so the gradients
reach the float32 parameters), the outputs come back as float32, and the
losses and the optimizer stay float32. ``align_only=True`` is the
alignment-first warmup objective: the loss is ``lambda * align``, while
recon and KL are still computed for the logs.

After each optimizer step ``models.sagan.sn_refresh`` advances every
spectral-norm site one power iteration; the epoch drivers run it as
their ``post_update``.

An optimizer built over the packed layout (``ops/packing.py``; its
``packer``) runs the module on the packer's views of its flat buffers
(``Packer.unpack``, whose backward is one ``cat`` a buffer), in bfloat16
casting each buffer once before cutting it; the gradients live in one
flat buffer (``parallel.mesh.GradBuffer``), zeroed in place each step.

Under a mesh the step averages the gradients over the ranks. The JAX
package's two mesh paths differ in their BatchNorm statistics: the
sharded epoch trainer (``shard_map``) normalises each shard with its own,
which is what a rank's local BatchNorm does; the eager ``--dp`` step is
GSPMD over the global batch, so ``global_stats=True`` takes the
statistics over the global batch (``nn.global_batch_stats``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..nn import global_batch_stats
from ..ops import losses
from ..parallel.mesh import GradBuffer
from ..utils.profiling import mark
from .steps import trained_params


def _forward(model, x, dtype, packer, noise, generator):
    """The model's forward: on ``dtype`` copies of its floating leaves and
    of ``x`` (the outputs upcast to float32) when ``dtype`` is given, and
    with a ``packer`` on the views of its flat buffers (cast once each)."""
    draws = {"noise": noise, "generator": generator}
    if dtype is None and packer is None:
        return model(x, **draws)
    leaves = packer.unpack(dtype=dtype) if packer is not None else {}
    if dtype is not None:
        for name, t in (*model.named_parameters(), *model.named_buffers()):
            if name not in leaves:
                leaves[name] = t.to(dtype) if t.is_floating_point() else t
        x = x.to(dtype)
    out = functional_call(model, leaves, (x,), draws)
    if dtype is None:
        return out
    up = [tuple(s.float() for s in v) if isinstance(v, tuple) else v.float()
          for v in out]
    return type(out)(*up)


def make_celeba_loss_fn(model, beta: float, lam: float,
                        compute_dtype: torch.dtype | None = None,
                        align_only: bool = False, packer=None) -> Callable:
    """``loss_fn(x, y, noise=None, generator=None) -> (loss, metrics)``,
    metrics ``loss, recon, KL, alignment, active`` as device scalars;
    with a ``packer`` the small parameters are read through its flat
    buffers."""
    node, latent_dim = model.node, model.latent_dim

    def loss_fn(x, y, noise=None, generator=None):
        out = _forward(model, x, compute_dtype, packer, noise, generator)
        recon = losses.l1_recon(out.xhat, x[..., :3] * 2.0 - 1.0)
        # KL2 subtracts node (not latent_dim) in the reference; they agree
        kl1 = losses.kl_std_normal(out.mean1, out.logvar1)
        kl2 = losses.kl_std_normal(out.mean2, out.logvar2)
        align = losses.alignment_bce(out.align_latent, y[:, :node])
        active = ((torch.exp(out.logvar1).mean(dim=0) < 0.1).sum()
                  + (torch.exp(out.logvar2).mean(dim=0) < 0.1).sum()) \
            / (node + latent_dim)
        loss = lam * align if align_only else \
            recon + beta * (kl1 + kl2) + lam * align
        metrics = {"loss": loss, "recon": recon, "KL": kl1 + kl2,
                   "alignment": align, "active": active.float()}
        return loss, metrics

    return loss_fn


def make_celeba_step(model, optimizer: torch.optim.Optimizer, beta: float,
                     lam: float, compute_dtype: torch.dtype | None = None,
                     align_only: bool = False, mesh=None,
                     global_stats: bool = False) -> Callable:
    """``step(x, y, noise=None, generator=None) -> metrics``: forward,
    backward, one Adam step. ``models.sagan.sn_refresh`` runs after it
    as the epoch driver's ``post_update``.

    Every trained parameter steps every step, as under optax's one step
    count: one the loss does not reach (the decoder under ``align_only``)
    steps with a zero gradient, which leaves it in place and keeps its
    Adam bias correction in step with the others'. ``mesh`` averages the
    gradients over its ranks; ``global_stats`` (under a mesh) normalises
    with the global batch's statistics (module docstring). An optimizer
    over the packed layout trains it (module docstring): its flat buffers'
    and big parameters' gradients are one buffer, which under a mesh is
    also the one the mean runs on.

    Unpacked on one device the gradients stay autograd's own, unbound
    each step: autograd hands a parameter the gradient it computed, where
    a view of one buffer takes one more kernel to accumulate it. At
    ``celeba_main``'s defaults that buffer cost 284 more kernels a step
    and 0.5-0.8 ms more device time, f32 and bf16, on an NVIDIA H100 80GB
    HBM3 at 700 W (``chip_smoke.py``'s phase 20 with and without it)."""
    packer = getattr(optimizer, "packer", None)
    loss_fn = make_celeba_loss_fn(model, beta, lam, compute_dtype,
                                  align_only, packer=packer)
    trained = [p for p in trained_params(optimizer) if p.requires_grad]
    stats_mesh = mesh if global_stats else None
    grads = GradBuffer(trained, mesh) \
        if mesh is not None or packer is not None else None

    def step(*batch, **draws):
        with global_batch_stats(stats_mesh):
            loss, metrics = loss_fn(*batch, **draws)
            mark("forward")
            if grads is None:
                optimizer.zero_grad(set_to_none=True)
            else:
                grads.zero()
            loss.backward()
        if grads is not None:
            grads.mean()
        else:
            for p in trained:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        mark("backward")
        optimizer.step()
        mark("optimizer")
        return {k: v.detach() for k, v in metrics.items()}

    return step
