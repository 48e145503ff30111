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

On a CUDA device without a mesh the trainer can replay each step from
one CUDA graph (``graph_noise=``), the counterpart of the reference's
``lax.scan`` over steps, which holds the rasteriser: before each replay
the host reseeds the step's generator and stages its DGP draws (the
batch function's :meth:`~OnlineBatch.draw` into static buffers), the
labeled rows and the step's noise, with the eager step's calls in its
order; the graph holds the DGP's transform, the render kernel's launch
into the image buffer, the label normalization, the step and Adam. It
equals the eager trainer bit for bit.

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
from functools import partial
from typing import Callable, NamedTuple

import torch

from ..data.pendulum import _BETA, sample_factors_real, shadow_physics
from ..data.pendulum_dr import sample_factors_dr
from ..ops.renderer import render
from ..parallel.mesh import rank_path
from ..utils.profiling import span
from ..utils.simulation import ONLINE_STEP, derived_seed
from .scanned import CapturedStep, NoisePlan, make_supervised_loss_fn
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


# each draw of a batch, in the generator's order (``Draws``' fields): the
# shape after the batch's rows, and the uniform's range or None for a
# standard normal
_DRAWS = (((), (math.pi / 4, math.pi / 2)), ((), (0.0, math.pi / 4)),
          ((), None), ((), None), ((2,), (0.0, 12.0)), ((), (0.0, 1.0)))


def sample_draws(generator: torch.Generator, n: int,
                 out: Draws | None = None) -> Draws:
    """Draw one batch's random numbers on the generator's device: the
    uniforms as ``torch.rand(...) * (hi - lo) + lo``, the normals as
    ``torch.randn``. ``out`` (the graphed trainer's static buffers)
    receives them in place, by the same calls, so the same generator
    gives the same values."""
    if out is None:
        out = Draws(*(torch.empty((n, *shape), device=generator.device)
                      for shape, _ in _DRAWS))
    for buf, (_, bounds) in zip(out, _DRAWS):
        if bounds is None:
            buf.normal_(generator=generator)
        elif bounds == (0.0, 1.0):
            buf.uniform_(generator=generator)
        else:
            lo, hi = bounds
            buf.uniform_(generator=generator).mul_(hi - lo).add_(lo)
    return out


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


class OnlineBatch:
    """A device DGP's batch function: ``sample(generator, index_offset=0)
    -> (x, y)``, device DGP draw -> render -> frozen-constant label
    normalization, in two halves that the graphed trainer runs apart:
    :meth:`draw` (the random numbers, from the generator, into static
    buffers when ``out`` is given) and :meth:`batch` (the rest, given the
    draws). ``x`` is :attr:`images`, one [batch_size, image_size,
    image_size, 3] buffer rendered in place at every call: it holds the
    latest batch until the next one. Made by :func:`pendulum_batch_fn`
    and :func:`dr_batch_fn`."""

    def __init__(self, batch_size: int, image_size: int, device):
        self.batch_size, self.image_size = batch_size, image_size
        self.device = torch.device(device)
        self.images = torch.empty((batch_size, image_size, image_size, 3),
                                  dtype=torch.float32, device=self.device)

    def __call__(self, generator: torch.Generator, index_offset: int = 0):
        return self.batch(self.draw(generator), index_offset)


class _PendulumBatch(OnlineBatch):
    def __init__(self, batch_size, image_size, norm_seed, norm_n, device):
        super().__init__(batch_size, image_size, device)
        self.mu, self.mn, self.mx = label_norm_stats(norm_seed, norm_n,
                                                     device=self.device)

    def draw(self, generator: torch.Generator,
             out: Draws | None = None) -> Draws:
        return sample_draws(generator, self.batch_size, out)

    def batch(self, draws: Draws, index_offset: int = 0):
        factors = factors_from_draws(draws, index_offset)
        x = render(factors[:, :4].contiguous(), size=self.image_size,
                   out=self.images)
        return x, ((factors - self.mu) - self.mn) / (self.mx - self.mn)


def pendulum_batch_fn(batch_size: int, image_size: int = 64,
                      norm_seed: int = 1, norm_n: int = 10000, *,
                      device: str | torch.device = "cuda") -> OnlineBatch:
    """The root pendulum family's :class:`OnlineBatch`: the pendulum_real
    DGP (:func:`sample_draws`, :func:`factors_from_draws`), the render,
    and the labels normalized by the constants of
    :func:`label_norm_stats`, computed once, here."""
    return _PendulumBatch(batch_size, image_size, norm_seed, norm_n, device)


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


class _DRBatch(OnlineBatch):
    def __init__(self, batch_size, image_size, norm_seed, norm_n, device):
        super().__init__(batch_size, image_size, device)
        self.mu4, self.mn, self.mx = dr_label_norm_stats(
            norm_seed, norm_n, device=self.device)

    def draw(self, generator: torch.Generator, out: tuple | None = None
             ) -> tuple[Draws, torch.Tensor]:
        """(the pendulum draws, then the background's uniform [n]), as
        :func:`sample_factors_dr_device` draws them."""
        draws = sample_draws(generator, self.batch_size,
                             None if out is None else out[0])
        if out is None:
            return draws, torch.rand((self.batch_size,), generator=generator,
                                     device=generator.device)
        return draws, out[1].uniform_(generator=generator)

    def batch(self, draws: tuple, index_offset: int = 0):
        f = dr_factors_from_draws(*draws, self.mu4,
                                  index_offset=index_offset)
        x = render(f[:, :4].contiguous(), size=self.image_size,
                   background=f[:, 4].contiguous(), out=self.images)
        y4 = ((f[:, :4] - self.mu4) - self.mn) / (self.mx - self.mn)
        return x, torch.cat([y4, f[:, 4:]], dim=1)


def dr_batch_fn(batch_size: int, image_size: int = 64, norm_seed: int = 1,
                norm_n: int = 10000, *,
                device: str | torch.device = "cuda") -> OnlineBatch:
    """The DR family's :class:`OnlineBatch`: the DR DGP (one more
    uniform, the background's), the render with the background bit, and
    the four physics labels normalized by the constants of
    :func:`dr_label_norm_stats`, computed once, here (background and
    target stay 0/1)."""
    return _DRBatch(batch_size, image_size, norm_seed, norm_n, device)


def _labeled_rows(n_l: int, batch_size_l: int,
                  generator: torch.Generator) -> torch.Tensor:
    """A step's labeled rows: ``batch_size_l`` of ``n_l``, without
    replacement."""
    return torch.randperm(n_l, generator=generator,
                          device=generator.device)[:batch_size_l]


class GraphedOnlineStep(CapturedStep):
    """One online step captured as a CUDA graph over static inputs: the
    DGP draws of ``sample_batch`` (an :class:`OnlineBatch`), the labeled
    rows (semi, ``labeled=(x_l, y_l)``) and the draws of ``plan``
    (``train.scanned.NoisePlan``). :meth:`stage` fills them from the
    step's generator in the eager step's order; :meth:`body`, what the
    graph holds, makes the batch from them (the DGP's transform, the
    render into the batch function's image buffer, the labels) and runs
    ``step`` on it. Both run as they are on any device; the graph exists
    only on CUDA."""

    def __init__(self, step: Callable, sample_batch: OnlineBatch, plan,
                 labeled: tuple | None = None, batch_size_l: int = 0):
        self._step, self._batch, self.plan = step, sample_batch, plan
        self._labeled, self._bs_l = labeled, batch_size_l
        device = sample_batch.device
        self.draws = sample_batch.draw(torch.Generator(device=device))
        self.rows_l = torch.zeros(batch_size_l, dtype=torch.long,
                                  device=device)
        super().__init__(self.body, device)

    def stage(self, generator: torch.Generator) -> None:
        """The step's draws, in the eager step's order: the batch's, the
        labeled rows, the step's noise (and marginal); a
        ``driver.stage`` span."""
        with span("driver.stage"):
            self._batch.draw(generator, out=self.draws)
            if self._labeled is not None:
                self.rows_l.copy_(_labeled_rows(len(self._labeled[0]),
                                                self._bs_l, generator))
            self.plan.draw(generator)

    def body(self) -> dict:
        x, y = self._batch.batch(self.draws)
        if self._labeled is None:
            return self._step(x, y, **self.plan.kwargs)
        x_l, y_l = self._labeled
        return self._step(x, x_l[self.rows_l], y_l[self.rows_l],
                          **self.plan.kwargs)

    def __call__(self, generator: torch.Generator) -> dict:
        """One step from ``generator`` (seeded for the step): a replay, or
        at the first call an eager step and then the capture. The metrics
        are copies: the graph's outputs are overwritten at every
        replay."""
        self.stage(generator)
        return {k: v.clone() for k, v in self.run().items()}


def make_online_run_from_loss(loss_fn: Callable, optimizer,
                              sample_batch: Callable,
                              n_steps_per_call: int, *, seed: int,
                              device: str | torch.device,
                              labeled: tuple | None = None,
                              batch_size_l: int = 0, mesh=None,
                              local_bs: int = 0,
                              graph_noise: Callable | None = None
                              ) -> Callable:
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
    [n_steps_per_call] keyed like ``loss_fn``'s, unsynced; each step is a
    ``driver.step`` span.

    Under a ``mesh`` this is one rank of the sharded trainer (module
    docstring): ``sample_batch`` draws ``local_bs`` rows, ``labeled`` is
    the rank's shard and ``batch_size_l`` its share, and the metrics are
    this rank's own (``cli.common.run_online_training`` averages them
    over the ranks).

    ``graph_noise(batch_size, device) -> train.scanned.NoisePlan`` turns
    on the CUDA-graph mode (module docstring): ``sample_batch`` must be an
    :class:`OnlineBatch`, ``loss_fn`` must take the plan's ``kwargs``
    (``noise=``, and ``perm=`` for InfoMax), ``device`` must be a CUDA
    device and there must be no mesh; anything else raises, and a failed
    capture raises. ``run.graphed`` is then the
    :class:`GraphedOnlineStep`, whose graph a caller may replay alone.
    """
    if graph_noise is not None:
        if mesh is not None:
            raise ValueError("the CUDA-graph online trainer runs on one "
                             "device; under a mesh the trainer is eager")
        if torch.device(device).type != "cuda":
            raise ValueError("the CUDA-graph online trainer needs a CUDA "
                             f"device (got {device})")
        if not isinstance(sample_batch, OnlineBatch):
            raise ValueError("the CUDA-graph online trainer stages the draws "
                             "of an OnlineBatch (pendulum_batch_fn, "
                             f"dr_batch_fn), not of {sample_batch!r}")
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

    def one_step(gen: torch.Generator) -> dict:
        x, y = sample_batch(gen, offset)
        if labeled is None:
            return step(x, y, generator=gen)
        idx = _labeled_rows(len(labeled[0]), batch_size_l, gen)
        return step(x, labeled[0][idx], labeled[1][idx], generator=gen)

    if graph_noise is not None:
        one_step = GraphedOnlineStep(
            step, sample_batch,
            graph_noise(sample_batch.batch_size, device=device),
            labeled, batch_size_l)

    def run(step0: int) -> dict:
        per_step = []
        for i in range(step0, step0 + n_steps_per_call):
            with span("driver.step"):
                generator.manual_seed(derived_seed(seed, ONLINE_STEP, i,
                                                   *path))
                per_step.append(one_step(generator))
        return {k: torch.stack([m[k] for m in per_step])
                for k in per_step[0]}

    run.graphed = one_step if graph_noise is not None else None
    return run


def make_online_scanned_steps(model, optimizer, beta: float, lam: float,
                              batch_size: int, n_steps_per_call: int,
                              image_size: int = 64, norm_seed: int = 1,
                              sample_batch: Callable | None = None, *,
                              seed: int = 0,
                              device: str | torch.device = "cuda",
                              compute_dtype: torch.dtype | None = None,
                              graphed: bool = False) -> Callable:
    """``n_steps_per_call`` supervised train steps of ``model``, each on a
    freshly sampled and rendered batch. ``sample_batch`` defaults to
    :func:`pendulum_batch_fn`; ``compute_dtype`` runs the forward in that
    dtype (``train/steps.py::cast_compute``), as the sharded online path
    does through ``make_supervised_loss_fn(compute_dtype=)``; ``graphed``
    replays each step from a CUDA graph (the step's noise staged in
    ``compute_dtype``, which the forward draws it in; a ``capturable``
    optimizer). Returns ``run(step0)`` as
    :func:`make_online_run_from_loss`."""
    loss_fn = make_supervised_loss_fn(model, beta, lam,
                                      compute_dtype=compute_dtype)
    if sample_batch is None:
        sample_batch = pendulum_batch_fn(batch_size, image_size, norm_seed,
                                         device=device)
    return make_online_run_from_loss(
        loss_fn, optimizer, sample_batch, n_steps_per_call, seed=seed,
        device=device, graph_noise=partial(NoisePlan, model,
                                           dtype=compute_dtype)
        if graphed else None)
