"""Copy parameters and Adam state between the JAX package's pytrees and
the port.

The JAX pytree is nested dicts of arrays, as ``jax.tree.map(np.asarray,
model.init(key))`` gives and as a checkpoint's ``state.pkl["params"]``
holds. The port's parameter and persistent buffer names are the tree's
keys joined with ``.``, with the same shapes, so the copy is one-to-one.
The buffers are the tree's leaves that do not train (spectral norm's
``u``/``v``, imported BatchNorm statistics); optax keeps zero moments for
them, as for a frozen trunk's parameters, and so does the export here.

``optax.adam``'s state is ``(ScaleByAdamState(count, mu, nu),
EmptyState())``: one int32 step ``count`` and two trees shaped like the
params. The TVAE's ``optax.chain(add_decayed_weights(wd), scale_by_adam(),
scale(-lr))`` keeps ``(EmptyState(), ScaleByAdamState(count, mu, nu),
EmptyState())``. ``torch.optim.Adam`` keeps ``step``, ``exp_avg`` and
``exp_avg_sq`` per parameter; ``mu -> exp_avg``, ``nu -> exp_avg_sq`` and
``count -> step`` of every parameter. The namedtuples below stand in for
the optax classes (the port does not import optax); ``utils/
checkpoint.py`` pickles them under optax's names.

An optimizer built over the packed layout (``ops/packing.py``; its
``packer`` attribute) steps one flat buffer per dtype: a small leaf's
moments are its slice of the buffer's, read and written here in the
canonical per-leaf layout, so a checkpoint does not depend on the layout.
"""
from __future__ import annotations

from collections import namedtuple
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = value
    return flat


ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
EmptyState = namedtuple("EmptyState", [])


def _nest(flat: Mapping) -> dict:
    """Dotted names -> nested dict (the inverse of :func:`_flatten`)."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _leaves(module: nn.Module) -> dict:
    """The module's leaves of the JAX tree: its parameters and its
    persistent buffers (spectral norm's ``u``/``v``, imported BatchNorm
    statistics), by dotted name."""
    return module.state_dict(keep_vars=True)


def _steps(p: torch.Tensor) -> bool:
    """Whether Adam steps this leaf: a parameter that trains (not a
    buffer, not a frozen trunk's)."""
    return isinstance(p, nn.Parameter) and p.requires_grad


def load_jax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy the arrays of ``tree`` into ``module``'s parameters and
    persistent buffers. A missing key, an extra key or a wrong shape
    raises before anything is copied."""
    flat = _flatten(tree)
    leaves = _leaves(module)
    missing = sorted(set(leaves) - set(flat))
    extra = sorted(set(flat) - set(leaves))
    if missing or extra:
        raise KeyError(f"param tree does not match the module: missing "
                       f"{missing}, unexpected {extra}")
    arrays = {}
    for name, p in leaves.items():
        arr = np.asarray(flat[name])
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} does not match "
                             f"{tuple(p.shape)}")
        arrays[name] = arr
    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(torch.as_tensor(np.array(arrays[name], dtype=np.float32)))


def _host(t: torch.Tensor, host: bool):
    t = t.detach()
    return t.cpu().numpy().copy() if host else t


def export_params(module: nn.Module, host: bool = True) -> dict:
    """The module's parameters and persistent buffers as a nested dict in
    the JAX pytree's layout (the inverse of :func:`load_jax_params`):
    numpy arrays, or with ``host=False`` the detached tensors on their
    device."""
    return _nest({name: _host(p, host)
                  for name, p in _leaves(module).items()})


def _layout(optimizer: torch.optim.Optimizer, module: nn.Module) -> list:
    """``(optimizer parameter, [(leaf name, shape, numel, offset), ...])``
    in the order of the optimizer's one param group: each of ``module``'s
    parameters alone, or under a packer its flat buffers and big
    parameters."""
    packer = getattr(optimizer, "packer", None)
    if packer is not None:
        return packer.layout()
    return [(p, [(name, tuple(p.shape), p.numel(), 0)])
            for name, p in module.named_parameters()]


def load_jax_opt_state(optimizer: torch.optim.Adam, module: nn.Module,
                       opt_tree) -> None:
    """Load optax Adam state, ``(ScaleByAdamState(count, mu, nu),
    EmptyState())`` or the TVAE chain's 3-tuple around it, into
    ``optimizer``, whose one param group holds ``module``'s parameters in
    ``named_parameters`` order, or its packer's flat buffers and big
    parameters (each buffer's moments hold its leaves' moments at their
    offsets, zero between them). The next ``optimizer.step()`` then takes the step optax
    would take. The moments of leaves that never step (buffers, frozen
    parameters: optax keeps them at zero) are not loaded."""
    states = [s for s in opt_tree if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(states) != 1:
        raise TypeError("not an optax Adam state: "
                        f"{[type(s).__name__ for s in opt_tree]}")
    adam = states[0]
    mu, nu = _flatten(adam.mu), _flatten(adam.nu)
    if set(mu) != set(_leaves(module)) or set(nu) != set(mu):
        raise KeyError("Adam state does not match the module's parameters")
    layout = _layout(optimizer, module)
    group_params = optimizer.param_groups[0]["params"]
    if [id(p) for p in group_params] != [id(p) for p, _ in layout]:
        raise ValueError("the optimizer's params are not the module's, in "
                         "named_parameters order, nor its packer's")
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)

    def moment(tree, p, leaves):
        flat = torch.zeros(p.numel(), dtype=torch.float32)
        for name, _, n, offset in leaves:
            flat[offset:offset + n] = torch.as_tensor(
                np.array(tree[name], np.float32)).reshape(-1)
        return flat.view(p.shape)
    state = {i: {"step": step.clone(), "exp_avg": moment(mu, p, leaves),
                 "exp_avg_sq": moment(nu, p, leaves)}
             for i, (p, leaves) in enumerate(layout) if _steps(p)}
    # load_state_dict moves each moment to its param's device and dtype
    optimizer.load_state_dict({
        "state": state,
        "param_groups": optimizer.state_dict()["param_groups"]})


def export_opt_state(optimizer: torch.optim.Adam, module: nn.Module,
                     decayed: bool = False, host: bool = True):
    """``optimizer``'s Adam state as optax's ``(ScaleByAdamState(count, mu,
    nu), EmptyState())``, or with ``decayed`` as the TVAE chain's
    ``(EmptyState(), ScaleByAdamState(...), EmptyState())``: numpy arrays,
    or with ``host=False`` tensors on the device (a packed leaf's, views
    of its buffer's moments). A leaf that has not
    stepped (a buffer, a frozen parameter, any parameter before the first
    step) has zero moments, and ``count`` is the one step count of those
    that have, as optax keeps them; 0 before the first step."""
    moments, steps = {}, set()
    for p, leaves in _layout(optimizer, module):
        st = optimizer.state.get(p, {}) if _steps(p) else {}
        if "step" in st:
            steps.add(int(st["step"]))
        if "exp_avg" in st:
            m, v = st["exp_avg"].reshape(-1), st["exp_avg_sq"].reshape(-1)
            for name, shape, n, offset in leaves:
                moments[name] = (m[offset:offset + n].view(shape),
                                 v[offset:offset + n].view(shape))
    mu, nu = {}, {}
    for name, p in _leaves(module).items():
        zeros = torch.zeros_like(p, dtype=torch.float32)
        m, v = moments.get(name, (zeros, zeros))
        mu[name], nu[name] = _host(m, host), _host(v, host)
    if len(steps) > 1:
        raise ValueError(f"parameters are at different Adam steps {steps}; "
                         "optax keeps one count")
    count = np.asarray(steps.pop() if steps else 0, dtype=np.int32)
    adam = ScaleByAdamState(count, _nest(mu), _nest(nu))
    if decayed:
        return (EmptyState(), adam, EmptyState())
    return (adam, EmptyState())
