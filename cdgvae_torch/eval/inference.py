"""Counterfactual inference: latent ranges, diagnostics and do-intervention
grids (port of ``cdgvae_tpu/eval/inference.py:1-111``).

Everything runs under ``torch.no_grad()`` on the model's device; results
come back as numpy arrays. The do-sweep decodes all its values as one
batch, where the reference maps one decode over them; every row is the
same computation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.losses import clipped_bce_probs


@torch.no_grad()
def encode_dataset(model, x_data: torch.Tensor, batch_size: int = 512
                   ) -> dict:
    """Deterministic encode of the whole dataset, ``batch_size`` images at
    a time. Returns numpy arrays: mean, logvar, epsilon (= mean),
    orig_latent, latent and logdet."""
    outs = [model.encode(x_data[i: i + batch_size], deterministic=True)
            for i in range(0, len(x_data), batch_size)]
    keys = ("mean", "logvar", "epsilon", "orig_latent", "latent", "logdet")
    return {k: torch.cat([o[j] for o in outs]).cpu().numpy()
            for j, k in enumerate(keys)}


def latent_ranges(encoded: dict):
    """(orig_min, orig_max, latent_min, latent_max) per node."""
    return (encoded["orig_latent"].min(0), encoded["orig_latent"].max(0),
            encoded["latent"].min(0), encoded["latent"].max(0))


def decode_image(model, latent: torch.Tensor) -> torch.Tensor:
    """The images of the model's masked ``decode`` (CDG-VAE's returns the
    per-block outputs too)."""
    dec = model.decode(latent)
    return dec[1] if isinstance(dec, tuple) else dec


@torch.no_grad()
def do_sweep(model, x_sample: torch.Tensor, do_index: int, values,
             deterministic: bool = True,
             generator: torch.Generator | None = None) -> np.ndarray:
    """Counterfactual sweep of one image ``x_sample`` [1, H, W, 3]: decode
    do(z_{do_index} := v) for each v. Returns [len(values), H, W, 3].
    ``deterministic=False`` sweeps from a posterior draw from
    ``generator``."""
    values = torch.as_tensor(np.asarray(values, np.float32),
                             device=x_sample.device)
    _, _, eps, _, latent, _ = model.encode(
        x_sample, generator=None if deterministic else generator,
        deterministic=deterministic)
    n = len(values)
    z_do = model.graph.do_intervention(latent.expand(n, -1),
                                       eps.expand(n, -1), do_index, values)
    return decode_image(model, z_do).cpu().numpy()


def do_grid(model, x_sample: torch.Tensor, latent_min, latent_max,
            n_values: int = 7) -> np.ndarray:
    """The do-intervention grid [node, n_values, H, W, 3]: for each node,
    the sweep over the linspace of its transformed-latent range, rounded
    to one decimal as the reference does."""
    rows = []
    for do_index in range(model.node):
        vals = np.round(np.linspace(latent_min[do_index],
                                    latent_max[do_index], n_values), 1)
        rows.append(do_sweep(model, x_sample, do_index, vals))
    return np.stack(rows, axis=0)


def alignment_cross_entropy(encoded: dict, labels) -> np.ndarray:
    """Per-node mean clipped BCE of sigmoid(latent) against the labels.
    Returns [node]."""
    z = encoded["latent"]
    if torch.is_tensor(labels):
        labels = labels.cpu().numpy()
    y = np.asarray(labels, np.float32)[:, : z.shape[1]]
    p = 1.0 / (1.0 + np.exp(-z))
    return clipped_bce_probs(torch.from_numpy(p),
                             torch.from_numpy(y)).mean(0).numpy()
