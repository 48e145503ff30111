"""One Adam step of a param group: the plain foreach chain and its CUDA
kernel (``csrc/adam.cu``).

Replaces no TPU kernel: on the TPU, XLA fuses optax's Adam update into
one pass; :func:`adam_plain`, the capturable Adam's foreach chain
(``train/steps.py::CapturableAdam``), takes 21 kernels and two more a
leaf on the card (55 a step for the pendulum's 17 leaves). It stays the
plain version and the CPU path. :func:`adam_step`
launches the kernel, which computes the chain's float32 update bit for
bit in one pass over every leaf (every trainer keeps its parameters and
Adam's state in float32); the library is built by ``nvcc`` at first
launch (``_build.py``) and bound with ``ctypes``. The wrapper checks the
leaves, launches on the current stream without synchronising and raises
if the launch fails. It never falls back to the plain version.

The leaf table (:class:`_Table`, mirrored from ``adam.cu``) is the
launch's by-value argument: each leaf's pointers and element count, the
first tile of each leaf, the group's scalars (:func:`tables`). A captured
CUDA graph keeps the copy its kernel node was given, so nothing has to
outlive the call. A group of more than :data:`MAX_LEAVES` leaves takes
one launch a :data:`MAX_LEAVES`.

``launches`` counts the kernels launched: each launch that runs now and
each launch recorded into a CUDA graph being captured, once (a replay
does not count).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# of each of the four streams a block takes a tile (adam.cu: kThreads 256
# x kVecs 2 x 16 B), and the leaves that fit a launch's 4 KB of kernel
# parameters (kMaxLeaves); checked against the library when it loads
TILE_BYTES = 8192
MAX_LEAVES = 77

launches = 0
_lib = None


class _Leaf(ctypes.Structure):
    _fields_ = [("param", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("exp_avg", ctypes.c_void_p),
                ("exp_avg_sq", ctypes.c_void_p), ("step", ctypes.c_void_p),
                ("numel", ctypes.c_longlong)]


class _Table(ctypes.Structure):
    _fields_ = [("neg_lr", ctypes.c_double), ("beta1", ctypes.c_double),
                ("beta2", ctypes.c_double),
                ("one_minus_beta1", ctypes.c_float),
                ("one_minus_beta2", ctypes.c_float),
                ("beta2_f", ctypes.c_float), ("eps", ctypes.c_float),
                ("weight_decay", ctypes.c_float), ("n_leaves", ctypes.c_int),
                ("ticket", ctypes.c_void_p),
                ("tile_start", ctypes.c_int * (MAX_LEAVES + 1)),
                ("leaf", _Leaf * MAX_LEAVES)]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build("adam", ["adam.cu"])))
        for name in ("table_bytes", "max_leaves", "tile_bytes"):
            getattr(lib, f"cdgvae_adam_{name}").restype = ctypes.c_int
        got = (lib.cdgvae_adam_table_bytes(), lib.cdgvae_adam_max_leaves(),
               lib.cdgvae_adam_tile_bytes())
        want = (ctypes.sizeof(_Table), MAX_LEAVES, TILE_BYTES)
        if got != want:
            raise RuntimeError(f"adam.cu's table (bytes, leaves, tile "
                               f"bytes) {got} is not the wrapper's {want}")
        lib.cdgvae_adam_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cdgvae_adam_step.restype = ctypes.c_int
        _lib = lib
    return _lib


def adam_plain(params: list, grads: list, steps: list, exp_avgs: list,
               exp_avg_sqs: list, *, lr: float, betas: tuple, eps: float,
               weight_decay: float) -> None:
    """One Adam step of ``params`` in place, their ``grads``, float32 0-d
    step counts and moments: the foreach chain of ``CapturableAdam``. The
    step counts rise by one; the bias corrections are computed from them
    in float64 on their device and rounded to float32, as the plain
    Adam's Python scalars are; then ``lerp`` and ``addcmul`` into the
    moments, the square root divided by sqrt(1 - b2^t), ``eps`` added,
    and ``param += -lr / (1 - b1^t) * exp_avg / denom``. It reads no host
    value, so a CUDA graph can hold it."""
    b1, b2 = betas
    torch._foreach_add_(steps, 1)
    if weight_decay:
        grads = torch._foreach_add(grads, params, alpha=weight_decay)
    torch._foreach_lerp_(exp_avgs, grads, 1 - b1)
    torch._foreach_mul_(exp_avg_sqs, b2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - b2)
    t = torch.stack(steps).double()
    step_size = (-lr / (1 - torch.pow(b1, t))).float()
    bc2_sqrt = (1 - torch.pow(b2, t)).sqrt().float()
    denom = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_div_(denom, list(bc2_sqrt.unbind()))
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(exp_avgs, denom)
    torch._foreach_mul_(update, list(step_size.unbind()))
    torch._foreach_add_(params, update)


def tables(pointers: list, numels: list, *, lr: float, betas: tuple,
           eps: float, weight_decay: float, ticket: int) -> list:
    """The leaf tables of a group's launches, the pure part of
    :func:`adam_step`: ``pointers`` holds each leaf's ``(param, grad,
    exp_avg, exp_avg_sq, step)`` addresses, ``numels`` its count of
    float32 elements, ``ticket`` the ticket counter's address. One
    :class:`_Table` a launch of at most :data:`MAX_LEAVES` leaves, in
    order; its ``tile_start`` is the running
    count of :data:`TILE_BYTES` tiles over the launch's leaves (leaf i's
    tiles are ``tile_start[i]:tile_start[i + 1]``, none for an empty
    leaf), so the grid is ``tile_start[n_leaves]`` blocks."""
    tile = TILE_BYTES // 4
    b1, b2 = betas
    out = []
    for first in range(0, len(numels), MAX_LEAVES):
        table = _Table(neg_lr=-lr, beta1=b1, beta2=b2,
                       one_minus_beta1=1 - b1, one_minus_beta2=1 - b2,
                       beta2_f=b2, eps=eps, weight_decay=weight_decay,
                       ticket=ticket)
        leaves = list(zip(pointers, numels))[first:first + MAX_LEAVES]
        table.n_leaves = len(leaves)
        for j, ((param, grad, m, v, step), n) in enumerate(leaves):
            table.leaf[j] = _Leaf(param, grad, m, v, step, n)
            table.tile_start[j + 1] = table.tile_start[j] + -(-n // tile)
        if table.tile_start[len(leaves)] >= 2 ** 31 - tile:
            raise ValueError("a launch's leaves hold too many tiles")
        out.append(table)
    return out


def _check_group(params, grads, steps, exp_avgs, exp_avg_sqs) -> None:
    """Raise on a group the kernel does not take."""
    device, dtype = params[0].device, params[0].dtype
    for i, leaf in enumerate(zip(params, grads, exp_avgs, exp_avg_sqs)):
        for name, t in zip(("param", "grad", "exp_avg", "exp_avg_sq"), leaf):
            if t.device != device or t.dtype != dtype:
                raise TypeError(f"leaf {i}'s {name} is {t.dtype} on "
                                f"{t.device}; the group's leaves are "
                                f"{dtype} on {device}")
            if t.numel() != leaf[0].numel() or not t.is_contiguous():
                raise ValueError(f"leaf {i}'s {name} must be contiguous "
                                 f"with its param's {leaf[0].numel()} "
                                 f"elements, got {list(t.shape)} strides "
                                 f"{list(t.stride())}")
        s = steps[i]
        if s.device != device or s.dtype != torch.float32 or s.numel() != 1:
            raise TypeError(f"leaf {i}'s step must be one float32 on "
                            f"{device}, got {s.dtype} {list(s.shape)} on "
                            f"{s.device}")
    if dtype != torch.float32:
        raise TypeError(f"adam_step takes float32 leaves, got {dtype}")
    if device.type != "cuda":
        raise ValueError(f"adam_step needs CUDA tensors, got {device}")


def adam_step(params: list, grads: list, steps: list, exp_avgs: list,
              exp_avg_sqs: list, *, lr: float, betas: tuple, eps: float,
              weight_decay: float, ticket: torch.Tensor) -> None:
    """:func:`adam_plain`'s step by the kernel, on one CUDA device: the
    leaves (``params``, ``grads``, ``exp_avgs``, ``exp_avg_sqs``) all
    float32, each contiguous, the step counts float32 0-d tensors on the
    same device. ``ticket`` is one zeroed int32
    on that device, kept by the caller for its launches; each launch
    leaves it zero. Raises on anything else, and if the launch fails."""
    global launches
    _check_group(params, grads, steps, exp_avgs, exp_avg_sqs)
    if (ticket.device != params[0].device or ticket.dtype != torch.int32
            or ticket.numel() != 1):
        raise TypeError(f"ticket must be one int32 on {params[0].device}, "
                        f"got {ticket.dtype} {list(ticket.shape)} on "
                        f"{ticket.device}")
    lib = _load()
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for table in tables(
                [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                  s.data_ptr()) for p, g, m, v, s in
                 zip(params, grads, exp_avgs, exp_avg_sqs, steps)],
                [p.numel() for p in params], lr=lr, betas=betas, eps=eps,
                weight_decay=weight_decay, ticket=ticket.data_ptr()):
            rc = lib.cdgvae_adam_step(ctypes.byref(table), stream)
            if rc != 0:
                raise RuntimeError(f"adam kernel launch failed: CUDA error "
                                   f"{rc}")
            launches += 1
