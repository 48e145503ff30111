"""Shared CLI plumbing (port of the parts of ``cdgvae_tpu/cli/common.py``
the port's CLIs use): list and bool flag parsers, the infrastructure
flags, ``--device`` and the reference's ``--platform``, ``--resume`` (the
InfoMax 4-tuple included), ``--dp`` (:func:`resolve_mesh`,
:func:`train_on_mesh`), and the fixed-dataset (supervised and
semi-supervised) and online training loops, on one device or on each
rank of a mesh.

``--dp N`` runs N ranks, one process each (``parallel/mesh.py``): NCCL on
``cuda:rank``, or gloo with ``--device cpu``. Every rank reads the data
and a ``--resume`` checkpoint; rank 0 broadcasts the parameters once, and
only rank 0 prints epoch lines, writes ``metrics.jsonl``, checkpoints,
figures and ``--profile`` traces.
"""
from __future__ import annotations

import argparse
import ast

import torch

from ..parallel.mesh import (check_devices, is_main, launch, shard_rows,
                             split_batch)
from ..train.loop import run_epochs, run_epochs_semi
from ..train.online import make_online_run_from_loss, train_split_size
from ..train.scanned import Averager, end_epoch

# --platform values and the device each means
_PLATFORM_DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def arg_as_list(s: str):
    """Parse a Python-literal list flag."""
    v = ast.literal_eval(s)
    if type(v) is not list:
        raise argparse.ArgumentTypeError(f'Argument "{s}" is not a list')
    return v


def arg_as_bool(s):
    """Boolean flag parser that makes '--flag False' mean False."""
    if isinstance(s, bool):
        return s
    v = s.strip().lower()
    if v in ("true", "1", "yes", "y"):
        return True
    if v in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f'expected a boolean, got "{s}"')


def _device_name(value: str) -> str:
    """``--device``'s value; empty (its default) means cuda."""
    return value or "cuda"


class _DeviceFlag(argparse.Action):
    """``--device``, and the reference's ``--platform``: ``cpu`` means
    ``--device cpu``, ``gpu`` or ``cuda`` means ``--device cuda``; any
    other backend is refused by name. The two may not disagree, in either
    order. ``--device`` defaults to the empty string, so that while
    parsing it reads as not given; argparse converts an untouched string
    default through ``type`` once parsing ends, which makes it cuda."""

    def __call__(self, parser, namespace, values, option_string=None):
        if option_string == "--device":
            device, platform = values, namespace.platform
        else:
            platform = values.strip().lower()
            if not platform:
                return
            if platform not in _PLATFORM_DEVICES:
                parser.error(f"--platform {values} is not supported by the "
                             "port: it runs on --platform gpu (or cuda) and "
                             "--platform cpu")
            device = namespace.device or _PLATFORM_DEVICES[platform]
            namespace.platform = platform
        if platform and torch.device(device).type != \
                _PLATFORM_DEVICES[platform]:
            parser.error(f"--platform {platform} contradicts --device "
                         f"{device}")
        namespace.device = device


def add_infra_args(parser: argparse.ArgumentParser):
    """Framework-side flags that have no reference counterpart."""
    parser.add_argument("--wandb", action="store_true",
                        help="log metrics to wandb too, if it is installed")
    parser.add_argument("--assets_dir", default="./assets", type=str,
                        help="output directory for figures and checkpoints")
    parser.add_argument("--n_samples", default=10000, type=int,
                        help="DGP sample count (10000 = reference; smaller "
                             "for smoke tests)")
    parser.add_argument("--eager", action="store_true",
                        help="per-batch epoch driver that keeps the last "
                             "partial batch (the reference's exact "
                             "protocol)")
    parser.add_argument("--profile", default="", type=str, metavar="DIR",
                        help="write a torch.profiler trace of the training "
                             "drive to DIR (utils/profiling.py ranks its "
                             "kernels)")
    parser.add_argument("--dp", default=0, type=int,
                        help="ranks of the data-parallel mesh, one process "
                             "each (0 = every visible GPU if the batch "
                             "divides over them, else one device; with "
                             "--device cpu, N gloo ranks)")
    add_device_arg(parser)
    return parser


def resolve_mesh(config: dict, extra_batch_sizes=()) -> int | None:
    """The number of ranks ``--dp`` asks for, or None for one device
    (``cdgvae_tpu/cli/common.py:159-179``): ``--dp 1`` is one device;
    ``--dp 0`` is every visible device (the GPUs under cuda, 1 on the CPU),
    or one device when a batch size does not divide over them; an explicit
    ``--dp N`` raises ``ValueError`` when ``batch_size`` or one of
    ``extra_batch_sizes`` (the labeled stream's ``batch_sizeL``) does not
    divide by N, and ``RuntimeError`` when N exceeds the visible GPUs."""
    dp = config.get("dp", 0)
    if dp < 0:
        raise ValueError(f"--dp {dp}: the rank count cannot be negative")
    kind = torch.device(config["device"]).type
    visible = torch.cuda.device_count() if kind == "cuda" else 1
    if dp == 1 or (dp == 0 and visible <= 1):
        return None
    n = dp if dp > 0 else visible
    for name, bs in [("batch_size", config["batch_size"])] + [
            ("extra batch size", b) for b in extra_batch_sizes]:
        if bs % n:
            if dp > 0:
                raise ValueError(f"{name} {bs} not divisible by dp={n}")
            return None
    check_devices(n, kind)
    return n


def _train_rank(mesh, train, config):
    train(config, mesh=mesh)


def train_on_mesh(train, config: dict, extra_batch_sizes=()):
    """Run ``train(config)`` as ``--dp`` asks: in this process on one
    device (returning what ``train`` returns), or as ``train(config,
    mesh=...)`` on each of N spawned ranks (returning None; rank 0 wrote
    the run's files). A ``--dp`` that cannot run exits naming why, before
    any rank starts; a rank that fails fails the run."""
    try:
        n = resolve_mesh(config, extra_batch_sizes)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"--dp {config.get('dp')}: {e}")
    if n is None:
        return train(config)
    kind = torch.device(config["device"]).type
    print(f"[dp] training on {n} ranks "
          f"({'nccl' if kind == 'cuda' else 'gloo'})", flush=True)
    launch(_train_rank, n, kind, train, config)
    return None


def add_png_data_dir_arg(parser: argparse.ArgumentParser):
    """``--data_dir`` for the pendulum and DR image CLIs: a
    reference-format PNG tree (``<dir>/{train,test}/a_*.png``, labels in
    the file names, e.g. written by ``cli.generate_data``) to train on
    instead of rendering the DGP. The training CLIs record it in the
    checkpoint's config, where the eval CLIs read it."""
    parser.add_argument("--data_dir", default="", type=str,
                        help="reference-format PNG dataset tree (default: "
                             "render the DGP on the device)")
    return parser


def add_device_arg(parser: argparse.ArgumentParser):
    """``--device`` and the reference's ``--platform`` (``cpu``, or
    ``gpu``/``cuda``), which sets it; the two may not disagree."""
    parser.add_argument("--device", default="", type=_device_name,
                        action=_DeviceFlag, help="cuda (default) or cpu")
    parser.add_argument("--platform", default="", type=str,
                        action=_DeviceFlag,
                        help="the reference's backend flag: cpu means "
                             "--device cpu, gpu or cuda --device cuda")
    return parser


def add_resume_arg(parser: argparse.ArgumentParser):
    parser.add_argument("--resume", default="", type=str,
                        help="checkpoint directory to resume from (restores "
                             "params + optimizer state + epoch)")
    return parser


def apply_resume(config: dict, state: tuple, prepare=None, mesh=None):
    """Restore ``state`` in place from ``--resume``: ``(model,
    optimizer)``, or for InfoMax ``(model, discriminator, optimizer,
    optimizer_d)``, whose discriminator and its Adam come from the
    checkpoint's extras ``d_params`` and ``opt_state_d``. ``prepare(ck)``,
    when given, returns the loaded checkpoint in the model's layout before
    it is copied in (the CelebA trainer's stacked decoder format).

    Returns (state, start_epoch). Refuses a checkpoint already at or past
    ``--epochs``, and an InfoMax resume from a checkpoint without the
    discriminator's state. Reads JAX-written checkpoints as well as the
    port's. Every rank of a ``mesh`` reads it; rank 0 says so.
    """
    if not config.get("resume"):
        return state, 0
    from ..utils.checkpoint import load_checkpoint
    from ..utils.interop import load_jax_opt_state, load_jax_params

    ck = load_checkpoint(config["resume"])
    if prepare is not None:
        ck = prepare(ck)
    start_epoch = int(ck["step"])
    if start_epoch >= config.get("epochs", float("inf")):
        raise ValueError(
            f"--resume checkpoint is at epoch {start_epoch}, which is "
            f"already >= --epochs {config['epochs']}; raising --epochs is "
            "required to continue (running on would retrain from scratch "
            "and overwrite the checkpoint's step metadata)")
    # keyed on the state's arity, as the reference does
    if len(state) == 4:
        model, discriminator, optimizer, optimizer_d = state
        ex = ck["extras"] or {}
        if "d_params" not in ex or "opt_state_d" not in ex:
            raise ValueError(
                "--resume: this InfoMax checkpoint has no discriminator "
                "state (saved by an older version); cannot resume")
        load_jax_params(discriminator, ex["d_params"])
        load_jax_opt_state(optimizer_d, discriminator, ex["opt_state_d"])
    else:
        model, optimizer = state
    load_jax_params(model, ck["params"])
    load_jax_opt_state(optimizer, model, ck["opt_state"])
    if is_main(mesh):
        print(f"resumed from {config['resume']} at epoch {start_epoch}")
    return state, start_epoch


def run_scanned_training(config, *, step, data, start_epoch=0, on_epoch=None,
                         post_epoch=None, post_epoch_pred=None, mesh=None,
                         graph_noise=None):
    """The fixed-dataset training branch: ``train.loop.run_epochs`` over
    ``data = (x, y)`` from ``start_epoch`` to ``config['epochs']``; under a
    ``mesh`` the sharded trainer (``step`` averaging over the same
    mesh); with ``graph_noise`` each step replays a CUDA graph
    (``train/scanned.py::make_epoch_runner``)."""
    x, y = data
    return run_epochs(step, x, y, seed=config["seed"],
                      epochs=config["epochs"],
                      batch_size=config["batch_size"],
                      start_epoch=start_epoch, on_epoch=on_epoch,
                      post_epoch=post_epoch, post_epoch_pred=post_epoch_pred,
                      mesh=mesh, graph_noise=graph_noise)


def graphed_epochs(config: dict, device: torch.device, mesh=None) -> bool:
    """Whether training runs as CUDA-graph replays, a captured step a
    batch (fixed datasets) or a step (``--online``): on a CUDA device, one
    device, not ``--eager``. The CPU stays eager, so a resumed CPU run
    equals the uninterrupted run bit for bit; ``--dp`` (a mesh) stays
    eager too. The optimizers are then built ``capturable``."""
    return (torch.device(device).type == "cuda" and mesh is None
            and not config.get("eager"))


def run_scanned_training_semi(config, *, step, data, start_epoch=0,
                              on_epoch=None, mesh=None, graph_noise=None):
    """The semi-supervised fixed-dataset branch: ``train.loop.
    run_epochs_semi`` over ``data = (x_u, x_l, y_l)``, each batch size
    clamped to its stream; under a ``mesh`` both streams are sharded;
    with ``graph_noise`` each step replays a CUDA graph."""
    x_u, x_l, y_l = data
    return run_epochs_semi(step, x_u, x_l, y_l, seed=config["seed"],
                           epochs=config["epochs"],
                           batch_size=config["batch_size"],
                           batch_size_l=config["batch_sizeL"],
                           start_epoch=start_epoch, on_epoch=on_epoch,
                           mesh=mesh, graph_noise=graph_noise)


def run_online_training(config, *, loss_fn, optimizer, device, start_epoch,
                        on_epoch, sample_batch_builder, labeled=None,
                        post_epoch=None, post_epoch_pred=None, mesh=None,
                        graph_noise=None):
    """The ``--online`` driver: epoch-equivalents of the reference
    protocol's steps per epoch (from the DGP's train-split size), each a
    run of fresh-batch steps; ``on_epoch`` gets the epoch's mean metrics
    (keys sorted) after one host sync, and ``post_epoch(epoch)`` runs where
    ``post_epoch_pred(epoch)`` holds. ``labeled=(x_l, y_l)`` switches to
    the semi-supervised loss, ``batch_sizeL`` clamped to the labeled
    rows. Under a ``mesh`` each rank draws its share of the batch and
    subsamples its shard of the labeled rows, and the metrics are the
    cross-rank mean (``cdgvae_tpu/cli/common.py:205-268``). With
    ``graph_noise`` (one device, CUDA) each step replays a CUDA graph
    (``train/online.py::make_online_run_from_loss``). The epoch's
    reduction and sync are a ``driver.epoch_end`` span
    (``train/scanned.py::end_epoch``)."""
    bs = config["batch_size"]
    steps_per_epoch = max(train_split_size(config["n_samples"]) // bs, 1)
    kw, local_bs = {}, bs
    if mesh is not None:
        local_bs = split_batch(bs, mesh)
        kw = dict(mesh=mesh, local_bs=local_bs)
    if labeled is not None:
        if mesh is None:
            bs_l = min(config["batch_sizeL"], len(labeled[0]))
        else:
            labeled = tuple(shard_rows(mesh, *labeled))
            bs_l = split_batch(min(config["batch_sizeL"],
                                   len(labeled[0]) * mesh.size), mesh,
                               name="batch_sizeL")
        kw.update(labeled=labeled, batch_size_l=bs_l)
    run = make_online_run_from_loss(loss_fn, optimizer,
                                    sample_batch_builder(local_bs),
                                    steps_per_epoch, seed=config["seed"],
                                    device=device, graph_noise=graph_noise,
                                    **kw)
    history = []
    for epoch in range(start_epoch, config["epochs"]):
        avg = Averager(mesh)
        avg.add(run(epoch * steps_per_epoch))
        metrics = end_epoch(avg)
        on_epoch(epoch, metrics)
        history.append(metrics)
        if post_epoch is not None and (post_epoch_pred is None
                                       or post_epoch_pred(epoch)):
            post_epoch(epoch)
    return history
