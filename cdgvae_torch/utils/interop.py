"""Copy parameters between the JAX package's param pytree and the port.

The JAX pytree is nested dicts of arrays, as ``jax.tree.map(np.asarray,
model.init(key))`` gives and as a checkpoint's ``state.pkl["params"]``
holds. The port's parameter names are the tree's keys joined with ``.``,
with the same shapes, so the copy is one-to-one.
"""
from __future__ import annotations

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
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().cpu().numpy().copy()
    return tree
