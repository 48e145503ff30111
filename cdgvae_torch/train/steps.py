"""Train steps for the pendulum family (port of ``cdgvae_tpu/train/
steps.py:28-265``): supervised, InfoMax and semi-supervised.

A step runs forward, loss, backward and the optimizer update in place on
the models and optimizer it closes over. Metrics come back as device
scalars keyed exactly like the reference's log dict (``loss, recon, KL,
alignment, [MutualInfo,] posterior_variance1..node``); the epoch runner
accumulates them on the device and syncs once per epoch.

Every stochastic input is either given (``noise=``, and for InfoMax the
marginal's ``perm=``/``shift=``) or drawn from the step's
``torch.Generator``, so a test can hand both packages the same draws.

The supervised step takes ``compute_dtype`` (``torch.bfloat16``) as the
reference's does: the forward runs on cast copies of the floating
parameters and of ``x`` (:func:`cast_compute`), while the parameters,
the optimizer and its state stay float32 and the losses upcast.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..ops import adam_cuda, losses
from ..parallel.mesh import GradBuffer
from ..utils.profiling import mark


def _metrics(loss, recon, kl, align, logvar, node, extra=None) -> dict:
    m = {"loss": loss, "recon": recon, "KL": kl, "alignment": align}
    if extra:
        m.update(extra)
    pv = losses.posterior_variance(logvar)
    for i in range(node):
        m[f"posterior_variance{i + 1}"] = pv[i]
    return m


def cast_compute(model: torch.nn.Module, x: torch.Tensor,
                 compute_dtype: torch.dtype) -> tuple[dict, torch.Tensor]:
    """Mixed precision as the reference's ``cast_compute``
    (``cdgvae_tpu/train/steps.py:43-49``): the model's floating
    parameters, as a name -> tensor dict for ``functional_call``, and
    ``x``, each cast to ``compute_dtype``. The casts are differentiable,
    so the gradients reach the float32 parameters as float32.

    The buffers are not cast: they are the reference's constants, which
    keep the model's float32. So the CDG-VAE's gathered latent times its
    float32 ``_valid`` is float32, and its whole decoder runs in float32
    on the bf16-rounded weights (``nn.stacked_dense`` and the band
    products cast the weight up where JAX promotes), while the encoder,
    the SEM solve (``I_B_inv`` follows eps's dtype) and the flows run in
    ``compute_dtype``; the baseline VAE runs wholly in it."""
    params = {n: p.to(compute_dtype) if p.is_floating_point() else p
              for n, p in model.named_parameters()}
    return params, x.to(compute_dtype)


def forward(model, x: torch.Tensor, noise=None, generator=None,
            compute_dtype: torch.dtype | None = None):
    """The model's band-sliced forward (``fast=True``); with a
    ``compute_dtype``, on :func:`cast_compute`'s copies. The outputs keep
    the dtypes the forward gives them: the losses upcast."""
    draws = {"noise": noise, "generator": generator, "fast": True}
    if compute_dtype is None:
        return model(x, **draws)
    params, x = cast_compute(model, x, compute_dtype)
    return functional_call(model, params, (x,), draws)


class CapturableAdam(torch.optim.Adam):
    """``torch.optim.Adam(capturable=True)`` with the plain Adam's update.

    torch's capturable update keeps the step counts on the device, as this
    one does, but raises the float32 betas to the float32 step there, so
    its bias corrections carry float32's rounding of 0.999: 1 - 0.999^t is
    off by about 1.3e-5 of itself at every step (the plain Adam computes
    it in Python doubles). Fed the same gradients, its parameters drifted
    from a float64 copy of optax's update 4.2-6.0 times as far as the
    plain Adam's over 200 steps on the H100 (``tools/adam_check.py``).
    This update computes the bias corrections in float64 on the device,
    from the step counts, rounds them to float32 as the plain update's
    scalars are rounded, and then runs the plain update's arithmetic in
    its order (``ops/adam_cuda.py::adam_plain``). A group of CUDA leaves
    takes one launch of the hand-written kernel (``adam_step``, the same
    update bit for bit; a group of more than ``MAX_LEAVES`` leaves one a
    ``MAX_LEAVES``), CPU leaves the plain foreach chain. No host value is
    read, so a CUDA graph can hold it. The state (``step``, ``exp_avg``,
    ``exp_avg_sq``) is torch Adam's, so checkpoints and
    ``utils/interop.py`` read it as they read any Adam's."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         capturable=True, weight_decay=weight_decay)
        # the kernel's ticket counter on each device, zeroed, kept for the
        # life of the optimizer (a captured graph's launches use it)
        self._tickets = {}

    def _groups(self):
        """Each param group's leaves that have a gradient, their state set
        up as torch Adam's: ``(params, grads, steps, exp_avgs,
        exp_avg_sqs)`` and the group's hyperparameters, as ``adam_plain``
        and ``adam_step`` take them."""
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            yield ((params, [p.grad for p in params],
                    [st["step"] for st in states],
                    [st["exp_avg"] for st in states],
                    [st["exp_avg_sq"] for st in states]),
                   dict(lr=group["lr"], betas=group["betas"],
                        eps=group["eps"],
                        weight_decay=group["weight_decay"]))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableAdam.step takes no closure")
        for leaves, hyper in self._groups():
            params = leaves[0]
            if any(p.is_cuda for p in params):
                device = params[0].device
                if device not in self._tickets:
                    self._tickets[device] = torch.zeros(
                        1, dtype=torch.int32, device=device)
                adam_cuda.adam_step(*leaves, **hyper,
                                    ticket=self._tickets[device])
            else:
                adam_cuda.adam_plain(*leaves, **hyper)

    @torch.no_grad()
    def plain_step(self) -> None:
        """The step by the plain foreach chain (``adam_plain``) on the
        leaves' device, whatever it is: the version the card's checks
        hold the kernel to, bit for bit."""
        for leaves, hyper in self._groups():
            adam_cuda.adam_plain(*leaves, **hyper)


def make_optimizer(model: torch.nn.Module, lr: float,
                   capturable: bool = False, weight_decay: float = 0.0,
                   packer=None) -> torch.optim.Adam:
    """Adam with optax.adam's defaults, whose update is algebraically the
    same: b1 0.9, b2 0.999, eps 1e-8 added outside the square root.
    ``capturable=True`` gives :class:`CapturableAdam`, which keeps its step
    counts on the device, so that a CUDA graph can hold the update.
    ``weight_decay`` adds ``wd * param`` to the gradient before the
    moments, as ``optax.chain(add_decayed_weights(wd), scale_by_adam(),
    scale(-lr))`` does. With a ``packer`` (``ops.packing.Packer`` of
    ``model``) it steps the packer's flat buffers and big parameters
    instead of ``model.parameters()``, and keeps the packer as its
    ``packer`` attribute, which the train steps and ``utils/interop.py``
    read."""
    params = model.parameters() if packer is None else packer.params()
    if capturable:
        optimizer = CapturableAdam(params, lr, weight_decay)
    else:
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
    optimizer.packer = packer
    return optimizer


def trained_params(optimizer) -> list:
    """The parameters ``optimizer`` updates (both models' for the InfoMax
    pair), in a fixed order."""
    return [p for opt in getattr(optimizer, "optimizers", (optimizer,))
            for group in opt.param_groups for p in group["params"]]


def step_from_loss(loss_fn: Callable, optimizer, mesh=None) -> Callable:
    """``step(*batch, **draws) -> metrics``: ``loss_fn(*batch, **draws) ->
    (loss, metrics)``, backward, and one ``optimizer.step()``; the metrics
    come back as detached device scalars, this rank's own. Under a
    ``mesh`` (``parallel.mesh.Mesh``) the gradients live in one flat
    buffer (``parallel.mesh.GradBuffer``), averaged over the ranks between
    backward and the optimizer step. In a CUDA graph's capture the ends of
    the forward, backward and optimizer phases are marked
    (``utils/profiling.py::mark``)."""
    grads = GradBuffer(trained_params(optimizer), mesh) \
        if mesh is not None else None

    def step(*batch, **draws):
        loss, metrics = loss_fn(*batch, **draws)
        mark("forward")
        if grads is None:
            optimizer.zero_grad(set_to_none=True)
        else:
            grads.zero()
        loss.backward()
        if grads is not None:
            grads.mean()
        mark("backward")
        optimizer.step()
        mark("optimizer")
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_train_step(model, optimizer: torch.optim.Optimizer, beta: float,
                    lam: float, free_bits: float = 0.0, mesh=None,
                    compute_dtype: torch.dtype | None = None) -> Callable:
    """Supervised VAE/CDG-VAE step.

    Returns step(x, y, noise=None, generator=None) -> metrics dict of
    detached device scalars. ``free_bits > 0`` floors the per-dim KL;
    ``mesh`` averages the gradients over its ranks; ``compute_dtype``
    runs the forward in that dtype (module docstring).
    """
    from .scanned import make_supervised_loss_fn

    return step_from_loss(make_supervised_loss_fn(
        model, beta, lam, free_bits=free_bits, compute_dtype=compute_dtype),
        optimizer, mesh)


def marginal_epsilon(epsilon: torch.Tensor, mode: str = "permutation", *,
                     perm: torch.Tensor | None = None, shift=None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """Mismatch eps against x for the InfoMax marginal term.

    ``"permutation"``: the rows of ``epsilon`` in the order ``perm`` (drawn
    from ``generator`` when not given). ``"roll"``: a cyclic shift by
    ``shift`` rows, 1..B-1 (drawn when not given), which never pairs a row
    with its own eps. The roll is a gather, so a device ``shift`` needs no
    host sync.
    """
    n, dev = epsilon.shape[0], epsilon.device
    if mode == "roll":
        if n < 2:
            raise ValueError(
                "InfoMax marginal needs a local batch of >= 2 (got "
                f"{n}); raise batch_size or lower the device count")
        if shift is None:
            shift = torch.randint(1, n, (), generator=generator, device=dev)
        return epsilon[(torch.arange(n, device=dev) - shift) % n]
    if mode != "permutation":
        raise ValueError(f"unknown marginal mode {mode!r}")
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=dev)
    return epsilon[perm]


def make_infomax_loss_fn(model, discriminator, beta: float, lam: float,
                         gamma: float, marginal: str = "permutation",
                         recon_fn: Callable = losses.gaussian_recon
                         ) -> Callable:
    """InfoMax joint loss over the model and the discriminator, as
    ``loss_fn(x, y, noise=None, perm=None, shift=None, generator=None) ->
    (grad_target, metrics)``.

    The reference calls ``loss.backward(retain_graph=True)`` and then
    ``MI.backward()``, so both the model and the discriminator accumulate
    (gamma + 1)·dMI: the gradient target is ``recon + β·KL + λ·align +
    (γ+1)·MI``, while the logged ``loss`` carries γ·MI. The noise is drawn
    before the marginal's permutation. ``recon_fn(xhat, x)`` is the
    reconstruction term.
    """
    node = model.node

    def loss_fn(x, y, noise=None, perm=None, shift=None, generator=None):
        out = model(x, noise=noise, generator=generator)
        recon = recon_fn(out.xhat, x)
        kl = losses.kl_std_normal(out.mean, out.logvar)
        align = losses.alignment_bce(out.align_latent, y[:, :node])
        d_joint = discriminator(x, out.epsilon)
        d_marginal = discriminator(x, marginal_epsilon(
            out.epsilon, marginal, perm=perm, shift=shift,
            generator=generator))
        mi = losses.infomax_mi(d_joint, d_marginal)
        ref_loss = recon + beta * kl + lam * align + gamma * mi
        metrics = _metrics(ref_loss, recon, kl, align, out.logvar, node,
                           {"MutualInfo": mi})
        return ref_loss + mi, metrics  # + mi: the extra MI.backward()

    return loss_fn


class _PairOptimizer:
    """Two optimizers driven as one: ``zero_grad`` and ``step`` go to
    both. Each keeps its own learning rate and state."""

    def __init__(self, optimizer, optimizer_d):
        self.optimizers = (optimizer, optimizer_d)

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        for opt in self.optimizers:
            opt.step()


def pair_infomax_optimizer(optimizer: torch.optim.Optimizer,
                           optimizer_d: torch.optim.Optimizer
                           ) -> _PairOptimizer:
    """The (model, discriminator) Adams as one optimizer, so the InfoMax
    pair rides any single-optimizer runner (the online trainer among
    them); the update equals stepping each apart."""
    return _PairOptimizer(optimizer, optimizer_d)


def make_infomax_step(model, discriminator,
                      optimizer: torch.optim.Optimizer,
                      optimizer_d: torch.optim.Optimizer,
                      beta: float, lam: float, gamma: float,
                      marginal: str = "permutation",
                      mesh=None) -> Callable:
    """InfoMax step ``step(x, y, noise=None, perm=None, shift=None,
    generator=None) -> metrics`` (see :func:`make_infomax_loss_fn` for the
    gradient). It updates both models in place, so it already has the
    single-state shape of the reference's ``pair_infomax_step``: the epoch
    runners drive it as they drive the supervised step. Under a ``mesh``
    both models' gradients are averaged in one buffer; pass ``marginal=
    "roll"`` there, as every sharded trainer of the reference does."""
    return step_from_loss(
        make_infomax_loss_fn(model, discriminator, beta, lam, gamma,
                             marginal),
        pair_infomax_optimizer(optimizer, optimizer_d), mesh)


def make_semi_loss_fn(model, beta: float, lam: float) -> Callable:
    """Semi-supervised loss: the ELBO on an unlabeled batch and the
    alignment of a separate labeled batch's deterministic encode, as
    ``loss_fn(x_u, x_l, y_l, noise=None, generator=None) -> (loss,
    metrics)``."""
    node = model.node

    def loss_fn(x_u, x_l, y_l, noise=None, generator=None):
        out = model(x_u, noise=noise, generator=generator, fast=True)
        recon = losses.gaussian_recon(out.xhat, x_u)
        kl = losses.kl_std_normal(out.mean, out.logvar)
        mean_l, _ = model.get_posterior(x_l)
        _, align_latent, _ = model.graph.transform(mean_l)
        align = losses.alignment_bce(align_latent, y_l[:, :node])
        loss = recon + beta * kl + lam * align
        return loss, _metrics(loss, recon, kl, align, out.logvar, node)

    return loss_fn


def make_semi_step(model, optimizer: torch.optim.Optimizer, beta: float,
                   lam: float, mesh=None) -> Callable:
    """Semi-supervised step ``step(x_u, x_l, y_l, noise=None,
    generator=None) -> metrics``; ``mesh`` averages the gradients over its
    ranks."""
    return step_from_loss(make_semi_loss_fn(model, beta, lam), optimizer,
                          mesh)
