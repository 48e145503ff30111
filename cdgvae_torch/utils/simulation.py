"""Seeding (port of ``cdgvae_tpu/utils/simulation.py:11-16``)."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators. The port's own
    randomness flows through explicit ``torch.Generator``s; this covers
    anything that reads the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
