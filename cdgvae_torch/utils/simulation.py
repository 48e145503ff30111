"""Seeding and the structure-recovery metrics of DAG estimates (port of
``cdgvae_tpu/utils/simulation.py:11-60``), and the derived generators
that take the place of ``jax.random.fold_in``.

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

from ..ops.causal import is_dag

# streams of derived generators, so that no two uses share a seed
EPOCH, ONLINE_STEP, VIZ_BATCH, VIZ_NOISE, DOWNSTREAM = range(5)


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators. The port's own
    randomness flows through explicit ``torch.Generator``s; this covers
    anything that reads the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def count_accuracy(B_true: np.ndarray, B_est: np.ndarray) -> dict:
    """fdr, tpr, fpr, shd and nnz of the estimated DAG ``B_est`` against
    ``B_true``, on boolean edge masks: an estimated edge is correct if the
    truth has it with the same orientation, reversed if only the flipped
    edge exists, and spurious if the skeleton lacks it; SHD is the
    skeleton mismatch plus one per reversed edge. A ``B_est`` that is not
    0/1, or not a DAG, raises ``ValueError``."""
    truth = np.asarray(B_true) != 0
    est = np.asarray(B_est)
    if not np.isin(est, (0, 1)).all():
        raise ValueError("B_est should take value in {0,1}")
    if not is_dag(est):
        raise ValueError("B_est should be a DAG")
    est = est == 1
    d = truth.shape[0]

    correct = est & truth
    flipped = est & truth.T & ~truth
    spurious = est & ~(truth | truth.T)
    n_wrong = int(flipped.sum() + spurious.sum())
    n_pred = int(est.sum())
    n_true = int(truth.sum())
    n_negative = d * (d - 1) / 2 - n_true

    lower = np.tril_indices(d)
    skel_est = (est | est.T)[lower]
    skel_true = (truth | truth.T)[lower]
    shd = int((skel_est != skel_true).sum() + flipped.sum())

    return {"fdr": n_wrong / max(n_pred, 1),
            "tpr": float(correct.sum()) / max(n_true, 1),
            "fpr": n_wrong / max(n_negative, 1),
            "shd": shd, "nnz": n_pred}


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
