"""Checkpoints: params + optimizer state + step + config, in the JAX
package's on-disk layout (port of ``cdgvae_tpu/utils/checkpoint.py:38-64,
156-187``).

A checkpoint directory holds ``state.pkl``, a pickle of ``{"params",
"opt_state", "step"}`` (plus ``"extras"`` when given), and ``config.json``
(indent 2, sorted keys). Leaves are numpy arrays; ``params`` is the JAX
param tree (``utils/interop.py::export_params``) and ``opt_state`` optax's
Adam state (``interop.export_opt_state``). So a checkpoint crosses between
the packages both ways:

* reading: a JAX-written ``state.pkl`` names the globals
  ``optax._src.transform.ScaleByAdamState`` and ``optax._src.base.
  EmptyState``. The loader's ``find_class`` maps both to the port's
  stand-ins, so it needs no optax (the GPU machine has none);
* writing: the port pickles its stand-ins under those same two names, so
  the JAX package's ``load_checkpoint`` reads a port checkpoint unchanged.
  ``pickle`` checks that a global it writes by name imports as the same
  object, which the stand-ins are not (with optax installed or without),
  so the writer emits these two names itself.

``AsyncCheckpointer`` (port of ``utils/checkpoint.py:102-153``) overlaps a
save with training: it snapshots the trees on the device and writes them
from a background thread.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
from typing import Any

import numpy as np
import torch

from .interop import EmptyState, ScaleByAdamState

_OPTAX_GLOBALS = {
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.base", "EmptyState"): EmptyState,
}
_GLOBAL_NAMES = {cls: name for name, cls in _OPTAX_GLOBALS.items()}


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, which writes the optax stand-ins' class
    references as optax's module and name (``STACK_GLOBAL``, protocol 4
    as ``pickle.dump`` uses)."""

    def save_global(self, obj, name=None):
        target = _GLOBAL_NAMES.get(obj)
        if target is None:
            return super().save_global(obj, name)
        self.save(target[0])
        self.save(target[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _OPTAX_GLOBALS:
            return _OPTAX_GLOBALS[(module, name)]
        return super().find_class(module, name)


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    config: dict | None = None,
                    extras: dict | None = None):
    """Write a self-describing checkpoint directory. ``params``,
    ``opt_state`` and ``extras`` (auxiliary state trees keyed by name,
    restored verbatim by load_checkpoint) hold numpy arrays."""
    os.makedirs(path, exist_ok=True)
    payload = {"params": params, "opt_state": opt_state, "step": step}
    if extras is not None:
        payload["extras"] = extras
    # write-to-temp + os.replace: a crash mid-write keeps the previous
    # checkpoint, which --resume depends on
    atomic_write(os.path.join(path, "state.pkl"), "wb",
                 lambda f: _Pickler(f, protocol=4).dump(payload))
    if config is not None:
        atomic_write(os.path.join(path, "config.json"), "w",
                     lambda f: json.dump(_jsonable(config), f, indent=2,
                                         sort_keys=True))


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and (named) tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _snapshot(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().clone()
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


class AsyncCheckpointer:
    """Checkpoint saves that overlap training.

    :meth:`save` snapshots the trees (numpy arrays or tensors, on the
    device or not) with one ``clone()`` a tensor, records a CUDA event
    after the clones, and returns. A background thread waits on that
    event, copies the snapshot to the host on a side stream and writes it
    with :func:`save_checkpoint`, so the bytes are those of a synchronous
    save. The caller may change its tensors in place as soon as
    :meth:`save` returns. At most one save is in flight: a second
    :meth:`save` waits for the first. A failed save raises on the next
    :meth:`save` or :meth:`wait`; call :meth:`wait` before the final
    save or exit."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def save(self, path: str, params, opt_state=None, step: int = 0,
             config: dict | None = None, extras: dict | None = None):
        self.wait()  # one save in flight; surface an earlier failure
        snap = _tree_map(_snapshot, (params, opt_state, extras))
        cuda = []
        _tree_map(lambda t: cuda.append(t) if torch.is_tensor(t)
                  and t.is_cuda else None, snap)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        config = None if config is None else dict(config)

        def to_host():
            if event is None:
                return _tree_map(lambda t: t.numpy() if torch.is_tensor(t)
                                 else t, snap)
            stream = torch.cuda.Stream(device=cuda[0].device)
            stream.wait_event(event)
            with torch.cuda.stream(stream):
                host = _tree_map(lambda t: t.to("cpu", non_blocking=True)
                                 if torch.is_tensor(t) else t, snap)
            stream.synchronize()
            return _tree_map(lambda t: t.numpy() if torch.is_tensor(t)
                             else t, host)

        def work():
            try:
                h_params, h_opt, h_extras = to_host()
                save_checkpoint(path, h_params, opt_state=h_opt, step=step,
                                config=config, extras=h_extras)
            except BaseException as e:  # raised by the next save/wait
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="async-ckpt")
        self._thread.start()

    def wait(self):
        """Block until the save in flight, if any, lands; raise if it
        failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint save failed") from err


def atomic_write(dest: str, mode: str, write):
    tmp = dest + ".tmp"
    with open(tmp, mode) as f:
        write(f)
    os.replace(tmp, dest)


def load_checkpoint(path: str) -> dict[str, Any]:
    """Returns {'params', 'opt_state', 'step', 'config', 'extras'}."""
    with open(os.path.join(path, "state.pkl"), "rb") as f:
        payload = _Unpickler(f).load()
    cfg_path = os.path.join(path, "config.json")
    payload["config"] = None
    payload.setdefault("extras", None)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            payload["config"] = json.load(f)
    return payload


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
