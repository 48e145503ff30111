"""Copy parameters and Adam state between the JAX package's pytrees and
the port.

The JAX pytree is nested dicts of arrays, as ``jax.tree.map(np.asarray,
model.init(key))`` gives and as a checkpoint's ``state.pkl["params"]``
holds. The port's parameter names are the tree's keys joined with ``.``,
with the same shapes, so the copy is one-to-one.

``optax.adam``'s state is ``(ScaleByAdamState(count, mu, nu),
EmptyState())``: one int32 step ``count`` and two trees shaped like the
params. The TVAE's ``optax.chain(add_decayed_weights(wd), scale_by_adam(),
scale(-lr))`` keeps ``(EmptyState(), ScaleByAdamState(count, mu, nu),
EmptyState())``. ``torch.optim.Adam`` keeps ``step``, ``exp_avg`` and
``exp_avg_sq`` per parameter; ``mu -> exp_avg``, ``nu -> exp_avg_sq`` and
``count -> step`` of every parameter. The namedtuples below stand in for
the optax classes (the port does not import optax); ``utils/
checkpoint.py`` pickles them under optax's names.
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


def load_jax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy the arrays of ``tree`` into ``module``'s parameters. A missing
    key, an extra key or a wrong shape raises before anything is copied."""
    flat = _flatten(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"param tree does not match the module: missing "
                       f"{missing}, unexpected {extra}")
    arrays = {}
    for name, p in params.items():
        arr = np.asarray(flat[name])
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} does not match "
                             f"{tuple(p.shape)}")
        arrays[name] = arr
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.as_tensor(np.array(arrays[name], dtype=np.float32)))


def export_params(module: nn.Module) -> dict:
    """The module's parameters as a nested dict of numpy arrays, in the
    JAX pytree's layout (the inverse of :func:`load_jax_params`)."""
    return _nest({name: p.detach().cpu().numpy().copy()
                  for name, p in module.named_parameters()})


def load_jax_opt_state(optimizer: torch.optim.Adam, module: nn.Module,
                       opt_tree) -> None:
    """Load optax Adam state, ``(ScaleByAdamState(count, mu, nu),
    EmptyState())`` or the TVAE chain's 3-tuple around it, into
    ``optimizer``, whose one param group holds ``module``'s parameters in
    ``named_parameters`` order. The next ``optimizer.step()`` then takes
    the step optax would take."""
    states = [s for s in opt_tree if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(states) != 1:
        raise TypeError("not an optax Adam state: "
                        f"{[type(s).__name__ for s in opt_tree]}")
    adam = states[0]
    mu, nu = _flatten(adam.mu), _flatten(adam.nu)
    named = list(module.named_parameters())
    if set(mu) != set(name for name, _ in named) or set(nu) != set(mu):
        raise KeyError("Adam state does not match the module's parameters")
    group_params = optimizer.param_groups[0]["params"]
    if [id(p) for p in group_params] != [id(p) for _, p in named]:
        raise ValueError("the optimizer's params are not the module's, in "
                         "named_parameters order")
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    state = {i: {"step": step.clone(),
                 "exp_avg": torch.as_tensor(np.array(mu[name], np.float32)),
                 "exp_avg_sq": torch.as_tensor(np.array(nu[name],
                                                        np.float32))}
             for i, (name, _) in enumerate(named)}
    # load_state_dict moves each moment to its param's device and dtype
    optimizer.load_state_dict({
        "state": state,
        "param_groups": optimizer.state_dict()["param_groups"]})


def export_opt_state(optimizer: torch.optim.Adam, module: nn.Module,
                     decayed: bool = False):
    """``optimizer``'s Adam state as optax's ``(ScaleByAdamState(count, mu,
    nu), EmptyState())`` of numpy arrays, or with ``decayed`` as the TVAE
    chain's ``(EmptyState(), ScaleByAdamState(...), EmptyState())``; zeros
    and count 0 before the first step, as the optax ``init`` gives."""
    mu, nu, steps = {}, {}, set()
    for name, p in module.named_parameters():
        st = optimizer.state.get(p, {})
        steps.add(int(st["step"]) if "step" in st else 0)
        zeros = np.zeros(tuple(p.shape), np.float32)
        mu[name] = (st["exp_avg"].detach().cpu().numpy().copy()
                    if "exp_avg" in st else zeros)
        nu[name] = (st["exp_avg_sq"].detach().cpu().numpy().copy()
                    if "exp_avg_sq" in st else zeros.copy())
    if len(steps) > 1:
        raise ValueError(f"parameters are at different Adam steps {steps}; "
                         "optax keeps one count")
    count = np.asarray(steps.pop() if steps else 0, dtype=np.int32)
    adam = ScaleByAdamState(count, _nest(mu), _nest(nu))
    if decayed:
        return (EmptyState(), adam, EmptyState())
    return (adam, EmptyState())
