"""Seeding (port of ``cdgvae_tpu/utils/simulation.py:11-16``) and the
derived generators that take the place of ``jax.random.fold_in``.

The JAX trainers fold each epoch's and each step's key from the run's key,
so a run resumed at epoch k draws what the uninterrupted run drew there.
The port does the same with one ``torch.Generator`` per epoch (or per
online step), seeded from ``(seed, stream, index)`` through numpy's
``SeedSequence``.
"""
from __future__ import annotations

import random

import numpy as np
import torch

# streams of derived generators, so that no two uses share a seed
EPOCH, ONLINE_STEP, VIZ_BATCH, VIZ_NOISE, DOWNSTREAM = range(5)


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators. The port's own
    randomness flows through explicit ``torch.Generator``s; this covers
    anything that reads the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def derived_seed(seed: int, *path: int) -> int:
    """A 64-bit seed that depends on ``seed`` and every entry of ``path``
    (non-negative ints)."""
    state = np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)
    return int(state[0])


def derived_generator(seed: int, *path: int,
                      device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with
    ``derived_seed(seed, *path)``."""
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, *path))
