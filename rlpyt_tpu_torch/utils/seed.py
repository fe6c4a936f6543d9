"""Seeding (port of rlpyt_tpu/utils/seed.py: set_seed, make_seed,
worker_seed).

The port's randomness runs on explicit ``torch.Generator``s that the
runner seeds from its ``seed``; these helpers cover the host edges
(Python and numpy generators in launchers and scripts) and the per-rank
offset convention.  ``set_seed`` leaves torch alone.
"""
from __future__ import annotations

import random
import time

import numpy as np


def set_seed(seed: int) -> None:
    """Seed Python's and numpy's global generators."""
    seed = int(seed) % (2**32)
    random.seed(seed)
    np.random.seed(seed)


def make_seed() -> int:
    """A seed from the clock's fractional second."""
    t = time.time()
    return int(1e6 * (t - int(t))) % (2**31)


def worker_seed(seed: int, rank: int) -> int:
    """The seed of worker ``rank``: ``seed + rank``."""
    return (int(seed) + int(rank)) % (2**31)
