"""Data parallelism over ``torch.distributed`` (port of ``cdgvae_tpu/
parallel/mesh.py``, with the row sharding of ``cdgvae_tpu/cli/common.py:
182-201`` and the batch split of ``cdgvae_tpu/train/online.py:286-293``).

The JAX package lays a 1-D ``dp`` mesh over the chips of one process:
params replicated, batches split over the mesh, one gradient ``psum`` a
step. The port runs one process a rank instead: NCCL with each rank on
``cuda:rank``, gloo on the CPU. The ranks rendezvous through a
``torch.distributed.FileStore`` in a temporary directory, so no TCP port
is taken. :func:`launch` spawns them (start method ``spawn``); an
exception in any rank ends the launch with an error, and nothing is
caught and carried on.

A serving mesh (:func:`make_mesh`) needs no process group: it names the
devices of this process, and ``api.LoadedModel`` keeps one model replica
on each.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh as this process sees it: ``size`` ranks
    (or serving devices), this process's ``rank`` and ``device``, the
    process group's ``backend`` and ``group`` (None for a serving mesh),
    and ``devices``, one a serving replica."""
    size: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    group: object = field(default=None, compare=False)
    devices: tuple = ()


def check_devices(n: int, device: str | torch.device) -> None:
    """Raise ``RuntimeError`` when ``n`` ranks need more GPUs than this
    machine shows; a CPU mesh takes any ``n``."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, not {n}")
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if visible < n:
            raise RuntimeError(
                f"requested a {n}-device mesh but only {visible} CUDA "
                "devices are visible; NCCL runs one rank a GPU, so use "
                "fewer devices (--dp), or for CPU testing pass --device "
                "cpu, which runs the ranks over gloo")


def make_mesh(n_devices: int, device: str | torch.device = "cuda") -> Mesh:
    """A serving mesh over the first ``n_devices`` GPUs (``device`` cuda)
    or ``n_devices`` replicas on the CPU; raises when short of GPUs."""
    device = torch.device(device)
    check_devices(n_devices, device)
    if device.type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(n_devices))
    else:
        devices = (torch.device("cpu"),) * n_devices
    return Mesh(size=n_devices, device=devices[0], devices=devices)


@contextlib.contextmanager
def process_group(rank: int, world_size: int, device: str,
                  store_path: str):
    """Join the process group of ``world_size`` ranks as ``rank`` (NCCL on
    ``cuda:rank``, gloo on the CPU), rendezvous at the FileStore
    ``store_path``; yields this rank's :class:`Mesh` and leaves the group
    on exit."""
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)
    try:
        yield Mesh(size=world_size, rank=rank, device=dev, backend=backend,
                   group=dist.group.WORLD, devices=(dev,))
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world_size: int, device: str, store_path: str,
               fn, args: tuple):
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores: one thread each
        torch.set_num_threads(1)
    with process_group(rank, world_size, device, store_path) as mesh:
        fn(mesh, *args)


def launch(fn, n: int, device: str | torch.device, *args) -> None:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, one process each, and wait
    for all of them. ``fn`` and ``args`` must pickle (``fn`` a module-level
    function). One rank runs in this process, in a world-1 group; more are
    spawned. Raises when short of GPUs (starting no rank) and when any rank
    fails."""
    device = torch.device(device).type
    check_devices(n, device)
    with tempfile.TemporaryDirectory(prefix="cdgvae_dp_") as tmp:
        store = os.path.join(tmp, "store")
        if n == 1:
            with process_group(0, 1, device, store) as mesh:
                fn(mesh, *args)
            return
        torch.multiprocessing.start_processes(
            _rank_main, args=(n, device, store, fn, args), nprocs=n,
            join=True, start_method="spawn")


def is_main(mesh: Mesh | None) -> bool:
    """Whether this process writes the run's output: the only process, or
    rank 0."""
    return mesh is None or mesh.rank == 0


def rank_path(mesh: Mesh | None) -> tuple:
    """What a rank adds to a derived generator's path: its rank, or nothing
    at world size 1, so that a world-1 run draws what one device draws."""
    return () if mesh is None or mesh.size == 1 else (mesh.rank,)


def split_batch(batch_size: int, mesh: Mesh,
                name: str = "batch_size") -> int:
    """Each rank's share of ``batch_size``; raises, naming the flag, when it
    does not divide over the mesh."""
    if batch_size % mesh.size:
        raise ValueError(f"{name} {batch_size} not divisible by "
                         f"{mesh.size} devices")
    return batch_size // mesh.size


def shard_rows(mesh: Mesh, *arrays):
    """This rank's contiguous block of the rows of each array, the block
    ``P("dp")`` gives device ``rank``. Rows that do not divide over the
    ranks are dropped (rank 0 says so); a dataset smaller than the device
    count raises."""
    out = []
    for a in arrays:
        n = (len(a) // mesh.size) * mesh.size
        if n == 0:
            raise ValueError(
                f"dataset ({len(a)} rows) smaller than the device count "
                f"({mesh.size}); use fewer devices (--dp) or more data")
        if n != len(a) and is_main(mesh):
            print(f"[dp] dropping {len(a) - n} of {len(a)} rows to shard "
                  f"evenly over {mesh.size} devices")
        per = n // mesh.size
        out.append(a[mesh.rank * per:(mesh.rank + 1) * per])
    return out


def _flat_apply(tensors: list, collective) -> None:
    """Run ``collective(flat)`` on one flat buffer of ``tensors`` (one
    dtype) and copy the result back into them."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_mean(tensors, mesh: Mesh) -> None:
    """Replace each tensor (float32) by its mean over the ranks, in place:
    one ``all_reduce`` of one flat buffer, then a division by the world
    size."""
    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
    _flat_apply(list(tensors), mean)


class GradBuffer:
    """The gradients of ``params`` (one dtype, one device) held as views of
    one flat buffer, as DDP's ``gradient_as_bucket_view`` holds them:
    backward accumulates into them in place, so the gradient mean over the
    mesh is one ``all_reduce`` of the buffer, with nothing gathered into it
    or copied out of it. The step that owns it calls :meth:`zero` where it
    would call ``optimizer.zero_grad`` (which would unbind the views) and
    :meth:`mean` between backward and the optimizer step. Every gradient
    is defined from the start: a parameter the loss does not reach steps
    with a zero gradient. Without a ``mesh`` it is the one gradient
    buffer of a packed layout's step (``ops/packing.py``), and
    :meth:`mean` leaves it as it is."""

    def __init__(self, params, mesh: Mesh | None):
        params = list(params)
        self.mesh = mesh
        self.flat = torch.zeros(sum(p.numel() for p in params),
                                dtype=params[0].dtype,
                                device=params[0].device)
        offset = 0
        for p in params:
            p.grad = self.flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()

    def zero(self) -> None:
        self.flat.zero_()

    def mean(self) -> None:
        if self.mesh is None:
            return
        dist.all_reduce(self.flat, group=self.mesh.group)
        self.flat.div_(self.mesh.size)


def replicate(mesh: Mesh, *modules: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank, one broadcast
    of one flat buffer a dtype."""
    by_dtype: dict = {}
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t.data)
    for tensors in by_dtype.values():
        _flat_apply(tensors, lambda flat: dist.broadcast(flat, 0,
                                                         group=mesh.group))
