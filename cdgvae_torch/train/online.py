"""Online (fresh-data-per-step) training for the pendulum and DR families,
single device (port of ``cdgvae_tpu/train/online.py:45-184,187-312``).

Every step draws a fresh batch from the pendulum_real DGP on the device,
renders it and takes a train step: no dataset, no input pipeline. On CUDA
the render is a launch of the hand-written kernel (``csrc/render.cu``)
into one image buffer that the batch function allocates once, so a step
allocates no images. Label normalization uses constants frozen once from
a host draw of the DGP's train split, so the alignment targets match the
fixed-dataset protocol.

The DGP is split into the draws (:func:`sample_draws`, from an explicit
``torch.Generator`` on the device) and a deterministic transform
(:func:`factors_from_draws`), so that a test can feed the draws
``jax.random`` makes through the port's transform. The 20% corruption is
positional, rows ``(arange(n) + 1 + index_offset) % 5 == 0``, as in the
reference.

Step i of a run draws its data and its noise from a generator derived from
``(seed, i)``, so a run resumed at a step continues as the uninterrupted
run would. Nothing in a step waits for the device or copies to it:
metrics stay on it until the caller reads them. The semi-supervised
trainer takes a fresh unlabeled batch every step and a subsample of a
labeled set that lies on the device. The DR DGP (:func:`dr_batch_fn`)
draws one more uniform, the background's, and renders the background bit
through the same kernel launch.

Under a mesh (``parallel.mesh.Mesh``) each rank draws its own batch of
``local_bs`` rows through the render kernel, from a generator derived from
``(seed, step, rank)`` (at world size 1 the single-device ``(seed,
step)``), with the corruption offset to the global rows ``rank ·
local_bs`` on; semi draws its labeled rows from the rank's own shard, and
the step averages the gradients (``cdgvae_tpu/train/online.py:
315-407``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..data.pendulum import _BETA, sample_factors_real, shadow_physics
from ..data.pendulum_dr import sample_factors_dr
from ..ops.renderer import render
from ..parallel.mesh import rank_path
from ..utils.simulation import ONLINE_STEP, derived_seed
from .scanned import make_supervised_loss_fn
from .steps import step_from_loss

_BETA_F = tuple(float(b) for b in _BETA)

def train_split_size(n: int) -> int:
    """Rows in the DGP's train split for an ``n``-sample draw (the 3:1
    ``(i + 1) % 4 == 0`` test holdout), for the reference protocol's steps
    per epoch without a dataset."""
    return n - n // 4


class Draws(NamedTuple):
    """The random numbers of one DGP batch of ``n`` rows, each float32."""
    light: torch.Tensor      # [n], U(pi/4, pi/2)
    angle: torch.Tensor      # [n], U(0, pi/4)
    length_noise: torch.Tensor    # [n], N(0, 1)
    position_noise: torch.Tensor  # [n], N(0, 1)
    resample: torch.Tensor   # [n, 2], U(0, 12): corrupted length, position
    target_u: torch.Tensor   # [n], U(0, 1): target = target_u < p


def sample_draws(generator: torch.Generator, n: int) -> Draws:
    """Draw one batch's random numbers on the generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) \
            * (hi - lo) + lo

    return Draws(uniform((n,), math.pi / 4, math.pi / 2),
                 uniform((n,), 0.0, math.pi / 4),
                 torch.randn((n,), generator=generator, device=dev),
                 torch.randn((n,), generator=generator, device=dev),
                 uniform((n, 2), 0.0, 12.0),
                 torch.rand((n,), generator=generator, device=dev))


def _physics_with_corruption(d: Draws, index_offset: int = 0):
    """Shadow physics, N(0, 0.1^2) measurement error and the positional
    every-5th corruption (offset to global row indices)."""
    n = d.light.shape[0]
    length, position = shadow_physics(d.light, d.angle, xp=torch)
    length = length + 0.1 * d.length_noise
    position = position + 0.1 * d.position_noise
    rows = torch.arange(n, device=d.light.device)
    corrupt = (rows + 1 + index_offset) % 5 == 0
    length = torch.where(corrupt, d.resample[:, 0], length)
    position = torch.where(corrupt, d.resample[:, 1], position)
    return d.light, d.angle, length, position


def _target(factors, target_u: torch.Tensor) -> torch.Tensor:
    """The target Bernoulli(p), p = sigmoid(logit - 2 sin(logit)), logit =
    ``factors`` (four columns) @ _BETA, as ``target_u < p`` float32."""
    # Python-float weights: a weight tensor would be a blocking
    # host-to-device copy every step
    logit = (factors[0] * _BETA_F[0] + factors[1] * _BETA_F[1]
             + factors[2] * _BETA_F[2] + factors[3] * _BETA_F[3])
    p = 1.0 / (1.0 + torch.exp(-logit + 2.0 * torch.sin(logit)))
    return (target_u < p).to(torch.float32)


def factors_from_draws(d: Draws, index_offset: int = 0) -> torch.Tensor:
    """The pendulum_real DGP as a function of its draws: [n, 5] float32
    (light, angle, length, position, target), the target Bernoulli(p) with
    the -2 sin(logit) nonlinearity."""
    f4 = _physics_with_corruption(d, index_offset)
    return torch.stack([*f4, _target(f4, d.target_u)], dim=1)


def sample_factors_device(generator: torch.Generator, n: int,
                          index_offset: int = 0) -> torch.Tensor:
    """Device-side pendulum_real DGP: [n, 5] float32 on the generator's
    device."""
    return factors_from_draws(sample_draws(generator, n), index_offset)


def label_norm_stats(seed: int = 1, n: int = 10000,
                     device: str | torch.device = "cpu"):
    """The reference protocol's label-normalization constants (train-split
    mean, centered min and max), from a host draw of the DGP, as float32
    tensors on ``device``: y = (factors - mu - min) / (max - min)."""
    factors, is_test = sample_factors_real(seed, n)
    train = factors[~is_test]
    mu = train.mean(axis=0)
    centered = train - mu
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (mu, centered.min(axis=0), centered.max(axis=0)))


def pendulum_batch_fn(batch_size: int, image_size: int = 64,
                      norm_seed: int = 1, norm_n: int = 10000, *,
                      device: str | torch.device = "cuda") -> Callable:
    """``sample_batch(generator, index_offset=0) -> (x, y)`` for the root
    pendulum family: device DGP draw -> render -> frozen-constant label
    normalization. The normalization constants are computed once, here.
    ``x`` is the same [batch_size, image_size, image_size, 3] buffer on
    every call, rendered in place: it holds the latest batch until the
    next call."""
    device = torch.device(device)
    mu, mn, mx = label_norm_stats(norm_seed, norm_n, device=device)
    images = torch.empty((batch_size, image_size, image_size, 3),
                         dtype=torch.float32, device=device)

    def sample(generator: torch.Generator, index_offset: int = 0):
        factors = sample_factors_device(generator, batch_size, index_offset)
        x = render(factors[:, :4].contiguous(), size=image_size, out=images)
        y = ((factors - mu) - mn) / (mx - mn)
        return x, y
    return sample


def dr_label_norm_stats(seed: int = 1, n: int = 10000,
                        device: str | torch.device = "cpu"):
    """The DR family's frozen constants, from a host draw of its train
    split: the mean of the four physics factors (it centres the target
    logit and the labels) and the centred min and max, float32 on
    ``device``. The background and target columns are 0/1 and stay raw."""
    train, _ = sample_factors_dr(seed, n)
    mu4 = train[:, :4].mean(axis=0)
    centered = train[:, :4] - mu4
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (mu4, centered.min(axis=0), centered.max(axis=0)))


def dr_factors_from_draws(d: Draws, background_u: torch.Tensor,
                          mu4: torch.Tensor, p1: float = 0.8,
                          p0: float = 0.2,
                          index_offset: int = 0) -> torch.Tensor:
    """The DR DGP's train split as a function of its draws: the pendulum
    physics, the target tau = ``target_u < p`` from the logit of the
    factors centred by the frozen train mean ``mu4`` [4] (a tensor on the
    draws' device), and the spurious background = ``background_u`` [n] <
    (p1 if tau else p0). No rounding to 4 decimals, as the reference's
    device twin. Returns [n, 6] float32 (light, angle, length, position,
    background, target)."""
    f4 = torch.stack(_physics_with_corruption(d, index_offset), dim=1)
    tau = _target((f4 - mu4).unbind(1), d.target_u)
    background = (background_u < torch.where(tau == 1.0, p1, p0)).to(
        torch.float32)
    return torch.cat([f4, background[:, None], tau[:, None]], dim=1)


def sample_factors_dr_device(generator: torch.Generator, n: int,
                             mu4: torch.Tensor, p1: float = 0.8,
                             p0: float = 0.2,
                             index_offset: int = 0) -> torch.Tensor:
    """Device-side DR DGP: [n, 6] float32 on the generator's device."""
    draws = sample_draws(generator, n)
    background_u = torch.rand((n,), generator=generator,
                              device=generator.device)
    return dr_factors_from_draws(draws, background_u, mu4, p1, p0,
                                 index_offset)


def dr_batch_fn(batch_size: int, image_size: int = 64, norm_seed: int = 1,
                norm_n: int = 10000, *,
                device: str | torch.device = "cuda") -> Callable:
    """``sample_batch(generator, index_offset=0) -> (x, y)`` for the DR
    family: device DGP draw -> render with the background bit ->
    frozen-constant normalization of the four physics labels (background
    and target stay 0/1). As :func:`pendulum_batch_fn`, the constants are
    computed once, here, and ``x`` is one buffer rendered in place."""
    device = torch.device(device)
    mu4, mn, mx = dr_label_norm_stats(norm_seed, norm_n, device=device)
    images = torch.empty((batch_size, image_size, image_size, 3),
                         dtype=torch.float32, device=device)

    def sample(generator: torch.Generator, index_offset: int = 0):
        f = sample_factors_dr_device(generator, batch_size, mu4,
                                     index_offset=index_offset)
        x = render(f[:, :4].contiguous(), size=image_size,
                   background=f[:, 4].contiguous(), out=images)
        y4 = ((f[:, :4] - mu4) - mn) / (mx - mn)
        return x, torch.cat([y4, f[:, 4:]], dim=1)
    return sample


def make_online_run_from_loss(loss_fn: Callable, optimizer,
                              sample_batch: Callable,
                              n_steps_per_call: int, *, seed: int,
                              device: str | torch.device,
                              labeled: tuple | None = None,
                              batch_size_l: int = 0, mesh=None,
                              local_bs: int = 0) -> Callable:
    """Online trainer for a supervised ``loss_fn(x, y, generator=...) ->
    (loss, metrics)`` over the models that ``optimizer`` updates (the
    InfoMax pair through ``steps.pair_infomax_optimizer``), or with
    ``labeled=(x_l, y_l)`` on ``device`` for the semi-supervised
    ``loss_fn(x_u, x_l, y_l, generator=...)``.

    Returns ``run(step0) -> per-step metrics``: steps ``step0 ..
    step0 + n_steps_per_call - 1``, each a fresh ``sample_batch`` draw
    (semi: its images are the unlabeled batch, and ``batch_size_l`` rows
    of the labeled set are drawn without replacement), forward, backward
    and optimizer step, with data and noise drawn from the generator
    derived from ``(seed, step)``. The metrics come back as device tensors
    [n_steps_per_call] keyed like ``loss_fn``'s, unsynced.

    Under a ``mesh`` this is one rank of the sharded trainer (module
    docstring): ``sample_batch`` draws ``local_bs`` rows, ``labeled`` is
    the rank's shard and ``batch_size_l`` its share, and the metrics are
    this rank's own (``cli.common.run_online_training`` averages them
    over the ranks).
    """
    if mesh is not None and local_bs <= 0:
        raise ValueError(
            "local_bs (each rank's draw size) is required under a mesh: "
            "without it the DGP's positional corruption would be offset by "
            "0 on every rank, changing the sampled distribution with the "
            "device count")
    offset = 0 if mesh is None else mesh.rank * local_bs
    path = rank_path(mesh)
    if labeled is not None and not 0 < batch_size_l <= len(labeled[0]):
        raise ValueError(
            f"labeled set ({len(labeled[0])} rows) cannot give a labeled "
            f"batch of {batch_size_l}; lower batch_sizeL or use more "
            "labeled data")
    generator = torch.Generator(device=device)
    step = step_from_loss(loss_fn, optimizer, mesh)

    def run(step0: int) -> dict:
        per_step = []
        for i in range(step0, step0 + n_steps_per_call):
            generator.manual_seed(derived_seed(seed, ONLINE_STEP, i, *path))
            x, y = sample_batch(generator, offset)
            if labeled is None:
                batch = (x, y)
            else:
                x_l, y_l = labeled
                idx = torch.randperm(len(x_l), generator=generator,
                                     device=generator.device)[:batch_size_l]
                batch = (x, x_l[idx], y_l[idx])
            per_step.append(step(*batch, generator=generator))
        return {k: torch.stack([m[k] for m in per_step])
                for k in per_step[0]}

    return run


def make_online_scanned_steps(model, optimizer, beta: float, lam: float,
                              batch_size: int, n_steps_per_call: int,
                              image_size: int = 64, norm_seed: int = 1,
                              sample_batch: Callable | None = None, *,
                              seed: int = 0,
                              device: str | torch.device = "cuda",
                              compute_dtype: torch.dtype | None = None
                              ) -> Callable:
    """``n_steps_per_call`` supervised train steps of ``model``, each on a
    freshly sampled and rendered batch. ``sample_batch`` defaults to
    :func:`pendulum_batch_fn`; ``compute_dtype`` runs the forward in that
    dtype (``train/steps.py::cast_compute``), as the sharded online path
    does through ``make_supervised_loss_fn(compute_dtype=)``. Returns
    ``run(step0)`` as :func:`make_online_run_from_loss`."""
    loss_fn = make_supervised_loss_fn(model, beta, lam,
                                      compute_dtype=compute_dtype)
    if sample_batch is None:
        sample_batch = pendulum_batch_fn(batch_size, image_size, norm_seed,
                                         device=device)
    return make_online_run_from_loss(loss_fn, optimizer, sample_batch,
                                     n_steps_per_call, seed=seed,
                                     device=device)
