"""The supervised loss, the epoch runners and uint8 dataset storage (port
of ``cdgvae_tpu/train/scanned.py:38-199,219-247``).

The epoch runners keep the semantics of ``make_scanned_epochs`` and
``make_scanned_epochs_semi``: one
permutation of the flat ``[n, 3·H·W]`` dataset per epoch from the epoch's
``torch.Generator`` (``train/loop.py::run_epochs`` derives it from the
seed and the epoch), the last partial batch dropped, metrics accumulated
on the device and averaged per epoch with one host sync per epoch. Steps
run as a Python loop of eager steps, or, in the CUDA-graph mode of both
runners (``graph_noise=``), as replays of one captured step: the
counterpart of the reference's compiled ``lax.scan``.

The graphed runners equal the eager ones step for step. Before each
replay a step stages its inputs into static buffers, in the order and
with the calls the eager step draws with: each index stream's row of the
epoch's permutations (one stream, or the unlabeled and the labeled one
of the semi-supervised runner), then the step's draws from the epoch's
generator (:class:`NoisePlan`: the noise and, for the InfoMax pair, the
marginal's permutation). The graph gathers the batch from the
device-resident data, decodes it, runs forward, backward, Adam and
``post_update``. The epoch's first step runs eagerly, on the stream the
capture uses (it makes Adam's state and the autograd buffers), and the
capture follows it, so no state is rolled back
(:class:`CapturedStep`, which the online trainer of ``train/online.py``
shares). The graph is kept for the runner's later epochs. It needs CUDA
data, one device (no mesh) and ``capturable`` Adams
(``train/steps.py::make_optimizer``); a failed capture raises, and
nothing falls back to the eager loop.

Both runners record host spans while a profiler records
(``utils/profiling.py::span``): each step a ``driver.step``, inside it
the graphed step's ``driver.stage`` and ``driver.replay``, and the
epoch's reduction and sync a ``driver.epoch_end``. A capture marks the
step's device phases with timing events in its graph
(``utils/profiling.py::mark``).

A uint8 dataset is quantized images (:func:`quantize_images`): both
runners gather its rows as bytes and decode them in the step
(:func:`unflatten_items`), so it trains what its dequantised float32
copy trains, bit for bit, on a quarter of the device memory.

Under a mesh (``parallel.mesh.Mesh``) the same runners are the sharded
trainers of ``cdgvae_tpu/train/scanned.py:276-466``: each rank runs them
on its own shard of the rows, with its own generator, at the local batch
size, the step averages the gradients, and the epoch metrics are the
cross-rank mean, reduced once an epoch (the mean is linear, so this equals
the reference's per-step ``pmean`` of the metrics).
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

from ..ops import losses, renderer_cuda
from ..parallel.mesh import all_reduce_mean
from ..utils.profiling import (capturing, count_replayed_step, mark,
                               phase_times, span)
from .steps import _metrics, forward


class Averager:
    """Accumulates copies of dicts of device tensors, each a step's
    scalar or a run's [steps] stack; ``result()`` is the mean over every
    step added, in one host sync, its keys sorted as JAX's pytree
    flattening orders them (and so the JAX trainers' console lines and
    logs). Under a ``mesh`` the result is the mean over its ranks too,
    one ``all_reduce``."""

    def __init__(self, mesh=None):
        self._acc = []
        self._mesh = mesh

    def add(self, metrics: dict):
        """Keep a copy of ``metrics``: a CUDA graph's outputs are the same
        tensors at every replay, overwritten each time."""
        self._acc.append({k: v.detach().clone() for k, v in metrics.items()})

    def result(self) -> dict:
        """The mean, which empties the averager: its copies are freed
        before it returns."""
        acc, self._acc = self._acc, []
        if not acc:
            return {}
        keys = sorted(acc[0])
        means = torch.stack([torch.cat([m[k].reshape(-1)
                                        for m in acc]).mean()
                             for k in keys])
        if self._mesh is not None:
            all_reduce_mean([means], self._mesh)
        return dict(zip(keys, means.tolist()))


def end_epoch(avg: Averager) -> dict:
    """An epoch's end, a ``driver.epoch_end`` span: ``avg.result()``, the
    epoch's one host sync, and right after it, while tracing, the read of
    the last replay's phases (``utils/profiling.py::phase_times``)."""
    with span("driver.epoch_end"):
        metrics = avg.result()
        phase_times.read()
    return metrics


def make_supervised_loss_fn(model, beta: float, lam: float,
                            free_bits: float = 0.0,
                            recon_fn: Callable = losses.gaussian_recon,
                            compute_dtype: torch.dtype | None = None
                            ) -> Callable:
    """ELBO + alignment loss as ``loss_fn(x, y, noise=None,
    generator=None) -> (loss, metrics)``; ``recon_fn(xhat, x)`` is the
    reconstruction term (the tabular family's is per dataset).
    ``compute_dtype`` runs the forward in that dtype
    (``train/steps.py::cast_compute``); the losses take float32 and the
    float32 ``x``."""
    node = model.node

    def loss_fn(x, y, noise=None, generator=None):
        out = forward(model, x, noise, generator, compute_dtype)
        recon = recon_fn(out.xhat, x)
        if free_bits > 0.0:
            kl = losses.kl_std_normal_free_bits(out.mean, out.logvar,
                                                free_bits)
        else:
            kl = losses.kl_std_normal(out.mean, out.logvar)
        align = losses.alignment_bce(out.align_latent, y[:, :node])
        loss = recon + beta * kl + lam * align
        return loss, _metrics(loss, recon, kl, align, out.logvar, node)

    return loss_fn


def quantize_images(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float images -> uint8 dataset storage,
    ``clip(round(x * 127.5 + 127.5), 0, 255)``: the product and the sum
    rounded apart, then half to even, as ``data/png_io.py::_to_uint8``
    encodes a PNG (``cdgvae_tpu/train/scanned.py:50-72``). The epoch
    runners decode it in the step. A capacity option: four times less
    device memory for the dataset, not a faster step."""
    return torch.round(x * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)


def unflatten_items(xi: torch.Tensor, item_shape) -> torch.Tensor:
    """Gathered flat rows [b, prod] back to items [b, *item_shape].
    CONTRACT, as the reference's ``_unflatten_item``: uint8 means a
    quantized image, decoded to ``(u8 - 127.5) / 127.5``. Discrete or
    one-hot tabular data must be float: a uint8 table would be rescaled
    to [-1, 1]."""
    xi = xi.reshape(xi.shape[0], *item_shape)
    if xi.dtype == torch.uint8:
        xi = (xi.float() - 127.5) / 127.5
    return xi


def epoch_batches(n: int, batch_size: int,
                  generator: torch.Generator) -> torch.Tensor:
    """One epoch's shuffled indices as [n // batch_size, batch_size]; the
    remainder is dropped."""
    steps = n // batch_size
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm[: steps * batch_size].reshape(steps, batch_size)


class NoisePlan:
    """A step's draws as static buffers, for the graphed runners: one
    buffer a draw the eager step makes, of the shapes
    ``model.noise_shapes(batch_size)`` in its draw order and in
    ``dtype`` (the step's compute dtype, float32 by default), on
    ``device``; with ``marginal="permutation"`` (the InfoMax pair) one
    more, the [batch_size] permutation of the marginal, which the eager
    step draws after the noise (``train/steps.py::marginal_epsilon``).
    :meth:`draw` fills them from a generator with the calls the eager
    step makes (``torch.randn`` is ``normal_`` on a new tensor; the
    permutation is ``torch.randperm``'s, copied in), so the same
    generator gives the same values; :attr:`kwargs` is the step's
    keyword arguments over them: ``noise=`` (``model.pack_noise``; also
    :attr:`noise`) and ``perm=``. With ``model`` None it plans a step that
    draws nothing (the CDM factor classifier's): no buffers, no keyword
    arguments."""

    def __init__(self, model, batch_size: int,
                 dtype: torch.dtype | None = None, device=None,
                 marginal: str | None = None):
        shapes = [] if model is None else model.noise_shapes(batch_size)
        self.buffers = [torch.empty(shape, dtype=dtype or torch.float32,
                                    device=device) for shape in shapes]
        self.noise = None if model is None else model.pack_noise(self.buffers)
        self.kwargs = {} if model is None else {"noise": self.noise}
        self.perm = None
        if marginal is not None:
            if marginal != "permutation":
                raise ValueError(
                    f"the graphed runners stage the 'permutation' marginal, "
                    f"not {marginal!r} (the mesh's, whose runners are "
                    "eager)")
            self.perm = torch.empty(batch_size, dtype=torch.long,
                                    device=device)
            self.kwargs["perm"] = self.perm

    def draw(self, generator: torch.Generator) -> None:
        for b in self.buffers:
            b.normal_(generator=generator)
        if self.perm is not None:
            self.perm.copy_(torch.randperm(len(self.perm),
                                           generator=generator,
                                           device=self.perm.device))


_CAPTURE_STREAMS: dict = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The side stream that every capture of the port (and its eager
    first step) runs on, one a device. torch caches cuBLAS workspaces for
    each stream cuBLAS has run on until the process ends: with a new
    stream a capture, a process that trained cut study seeds of two
    captures each held 128 MiB more after every seed on the H100. torch's
    own graph context keeps one default capture stream for the same
    reason."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class CapturedStep:
    """``body() -> metrics`` as a CUDA graph on ``device``: :meth:`run`
    runs it eagerly the first time, on the stream the capture then uses,
    captures it, and replays the graph at every later call (:meth:`replay`
    alone replays it, for timing); the metrics are the graph's static
    outputs, the same tensors at every replay. A replay is a
    ``driver.replay`` span, counts toward an open ``--profile`` trace
    (``utils/profiling.py::count_replayed_step``), adds the render
    launches the graph holds to ``ops/renderer_cuda.py``'s count
    (:attr:`renders`: those its capture recorded) and leaves its phase
    marks (:attr:`marks`, the timing events the capture recorded) to be
    read at the next host sync.

    The garbage collector runs before each capture: a dead reference cycle
    that holds an earlier runner's graph (a seed's or an arm's, in a
    process that trains several), collected while the stream captures,
    would reset that graph inside the capture and invalidate it, and
    torch's graph context no longer collects first."""

    def __init__(self, body: Callable[[], dict], device):
        self.body, self.device = body, torch.device(device)
        self.graph, self.metrics, self.renders = None, None, 0
        self.marks = None

    def replay(self) -> None:
        """One replay of the captured graph, counted."""
        with span("driver.replay"):
            self.graph.replay()
            renderer_cuda.count_replay(self.renders)
            count_replayed_step()
        phase_times.latest = self.marks

    def run(self) -> dict:
        if self.graph is not None:
            self.replay()
            return self.metrics
        current = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self.body()
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        recorded = renderer_cuda.captured
        # thread_local: a checkpoint thread's copies may run meanwhile
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"), \
                capturing() as marks:
            self.metrics = self.body()
        current.wait_stream(side)
        self.graph, self.renders = graph, renderer_cuda.captured - recorded
        self.marks = marks
        return metrics


class GraphedStep(CapturedStep):
    """One training step captured as a CUDA graph over static inputs: the
    row indices of each index stream and the draws of ``plan``.
    ``streams`` lists, for each index stream, its batch size and the
    tensors its rows gather, as ``(tensor, item_shape)`` pairs: flat rows
    decoded to items of ``item_shape`` (:func:`unflatten_items`), or with
    ``item_shape`` None taken as they are (the labels). The step gets the
    gathered tensors in that order: ``[(bs, [(xf, shape), (y, None)])]``
    for ``step(x, y)``, two streams for the semi-supervised
    ``step(x_u, x_l, y_l)``. The data are read where they lie, so the
    graph holds to those tensors. :meth:`stage` and :meth:`body` are the
    two halves of a step, which run as they are on any device; the graph
    exists only on CUDA."""

    def __init__(self, step_fn, post_update, plan: NoisePlan, streams):
        self._step, self._post, self.plan = step_fn, post_update, plan
        self._streams = [gathers for _, gathers in streams]
        device = streams[0][1][0][0].device
        self.rows = [torch.zeros(bs, dtype=torch.long, device=device)
                     for bs, _ in streams]
        super().__init__(self.body, device)

    def holds(self, *data) -> bool:
        """Whether the graph gathers from exactly ``data``, in order."""
        mine = [t for gathers in self._streams for t, _ in gathers]
        return len(mine) == len(data) and all(
            a.data_ptr() == b.data_ptr() and a.shape == b.shape
            for a, b in zip(mine, data))

    def stage(self, rows, generator: torch.Generator) -> None:
        """The step's inputs: each stream's rows into its index buffer,
        and the plan's draws from ``generator``, drawn as the eager step
        draws them (a ``driver.stage`` span)."""
        with span("driver.stage"):
            for buf, r in zip(self.rows, rows):
                buf.copy_(r)
            self.plan.draw(generator)

    def body(self) -> dict:
        """What the graph holds: the gathers and decodes of the staged
        rows, the step on the staged draws, and ``post_update`` (its phase
        marked)."""
        batch = [t[idx] if shape is None else unflatten_items(t[idx], shape)
                 for idx, gathers in zip(self.rows, self._streams)
                 for t, shape in gathers]
        metrics = self._step(*batch, **self.plan.kwargs)
        if self._post is not None:
            self._post()
            mark("post_update")
        return metrics

    def __call__(self, rows, generator: torch.Generator) -> dict:
        """One step on the batches ``rows`` (one index tensor a stream): a
        replay, or at the first call an eager step and then the
        capture."""
        self.stage(rows, generator)
        return self.run()


def _graphed_step(run, step_fn, post_update, plan, streams,
                  data) -> GraphedStep:
    """The runner's captured step, made at its first call and kept (as
    ``run.graphed``, whose graph a caller may replay alone); ``data``,
    the tensors it gathers, must be CUDA tensors, the same every call."""
    if not all(t.is_cuda for t in data):
        raise ValueError("the CUDA-graph epoch runner needs the data on a "
                         f"CUDA device (got {[str(t.device) for t in data]})")
    if run.graphed is None:
        run.graphed = GraphedStep(step_fn, post_update, plan(), streams)
    elif not run.graphed.holds(*data):
        raise ValueError("the CUDA-graph epoch runner was captured on "
                         "another dataset; make a runner for this one")
    return run.graphed


def make_epoch_runner(step_fn: Callable, batch_size: int,
                      post_update: Callable | None = None,
                      mesh=None, graph_noise: Callable | None = None
                      ) -> Callable:
    """Wrap a ``step(x, y, generator=...) -> metrics`` into an epoch runner,
    the counterpart of ``make_scanned_epochs``.

    Returns run(x, y, generator) -> the epoch's mean metrics as host
    floats, keys sorted. ``x`` is [n, ...] items, ``y`` [n, .]; both on
    the generator's device, which draws the permutation and then each
    step's noise; a uint8 ``x`` is decoded in the step
    (:func:`unflatten_items`). ``post_update()`` runs after every step
    (the TVAE's sigma clamp, the CelebA ``sn_refresh``). Under a ``mesh``
    each rank runs it on its shard at its local ``batch_size`` (module
    docstring).

    ``graph_noise(batch_size, device) -> NoisePlan`` turns on the
    CUDA-graph mode (module docstring): ``step`` must also take the
    plan's ``kwargs`` (``noise=``, and ``perm=`` for InfoMax), and ``x``,
    ``y`` must be CUDA tensors, the same ones every epoch, without a
    mesh; anything else raises. ``run.graphed`` is then the
    :class:`GraphedStep`, once the first epoch has made it.
    """
    if graph_noise is not None and mesh is not None:
        raise ValueError("the CUDA-graph epoch runner runs on one device; "
                         "under a mesh the runner is eager")

    def run(x, y, generator: torch.Generator) -> dict:
        n = x.shape[0]
        steps = n // batch_size
        if steps == 0:
            raise ValueError(
                f"dataset ({n}) smaller than batch_size ({batch_size}); "
                "clamp the batch size (train.loop.run_epochs does)")
        xf, item_shape = x.reshape(n, -1), x.shape[1:]
        avg = Averager(mesh)
        batches = epoch_batches(n, batch_size, generator)
        if graph_noise is None:
            for idx in batches:
                with span("driver.step"):
                    xi = unflatten_items(xf[idx], item_shape)
                    avg.add(step_fn(xi, y[idx], generator=generator))
                    if post_update is not None:
                        post_update()
            return end_epoch(avg)  # the one host sync
        graphed = _graphed_step(
            run, step_fn, post_update,
            lambda: graph_noise(batch_size, device=x.device),
            [(batch_size, [(xf, item_shape), (y, None)])], (xf, y))
        for idx in batches:
            with span("driver.step"):
                avg.add(graphed((idx,), generator))
        return end_epoch(avg)  # the one host sync

    run.graphed = None
    return run


def labeled_batches(n_l: int, steps: int, batch_size_l: int,
                    generator: torch.Generator) -> torch.Tensor:
    """An epoch's labeled indices as [steps, batch_size_l]: ``ceil(steps ·
    batch_size_l / n_l)`` permutations of ``n_l`` concatenated and cut, so
    every batch is full and the stream reshuffles when it runs out."""
    need = steps * batch_size_l
    perms = [torch.randperm(n_l, generator=generator, device=generator.device)
             for _ in range(-(-need // n_l))]
    return torch.cat(perms)[:need].reshape(steps, batch_size_l)


def make_scanned_epochs_semi(step_fn: Callable, batch_size: int,
                             batch_size_l: int, mesh=None,
                             graph_noise: Callable | None = None
                             ) -> Callable:
    """Semi-supervised epoch runner, the counterpart of
    ``make_scanned_epochs_semi``: the unlabeled stream drives the epoch and
    drops its remainder; the labeled stream cycles through
    :func:`labeled_batches`, so every labeled batch is exactly
    ``batch_size_l``. The epoch's generator draws the unlabeled
    permutation, then the labeled ones, then each step's noise.

    ``step_fn(x_u, x_l, y_l, generator=...) -> metrics``. Returns
    run(x_u, x_l, y_l, generator) -> the epoch's mean metrics as host
    floats, keys sorted. Use ``train.loop.train_epoch_semi`` (``--eager``)
    for the reference's protocol with short batches. Under a ``mesh``
    each rank cycles its own labeled shard (module docstring). A uint8
    stream is decoded in the step (:func:`unflatten_items`).
    ``graph_noise`` is :func:`make_epoch_runner`'s CUDA-graph mode, with
    two index streams: the unlabeled rows and the labeled ones.
    """
    if graph_noise is not None and mesh is not None:
        raise ValueError("the CUDA-graph epoch runner runs on one device; "
                         "under a mesh the runner is eager")

    def run(x_u, x_l, y_l, generator: torch.Generator) -> dict:
        n_u, n_l = x_u.shape[0], x_l.shape[0]
        steps = n_u // batch_size
        if steps == 0 or n_l < batch_size_l:
            raise ValueError(
                f"streams too small (unlabeled {n_u} vs batch {batch_size}; "
                f"labeled {n_l} vs batch {batch_size_l}); clamp the batch "
                "sizes or use the eager train_epoch_semi")
        xf_u, xf_l = x_u.reshape(n_u, -1), x_l.reshape(n_l, -1)
        idx_u = epoch_batches(n_u, batch_size, generator)
        idx_l = labeled_batches(n_l, steps, batch_size_l, generator)
        avg = Averager(mesh)
        if graph_noise is None:
            for iu, il in zip(idx_u, idx_l):
                with span("driver.step"):
                    avg.add(step_fn(
                        unflatten_items(xf_u[iu], x_u.shape[1:]),
                        unflatten_items(xf_l[il], x_l.shape[1:]),
                        y_l[il], generator=generator))
            return end_epoch(avg)  # the one host sync
        graphed = _graphed_step(
            run, step_fn, None,
            lambda: graph_noise(batch_size, device=x_u.device),
            [(batch_size, [(xf_u, x_u.shape[1:])]),
             (batch_size_l, [(xf_l, x_l.shape[1:]), (y_l, None)])],
            (xf_u, xf_l, y_l))
        for iu, il in zip(idx_u, idx_l):
            with span("driver.step"):
                avg.add(graphed((iu, il), generator))
        return end_epoch(avg)  # the one host sync

    run.graphed = None
    return run
