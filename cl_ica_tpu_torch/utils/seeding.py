"""Deterministic seeding across Python, numpy and torch.

Port of cl_ica_tpu/utils/seeding.py, with a ``torch.Generator`` where the
JAX package returns a PRNG key."""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
import torch


def seed_everything(seed: int) -> Tuple[np.random.Generator, torch.Generator]:
    """Seed Python's and numpy's global generators (host-side init code,
    e.g. the condition-number pool) and return (numpy Generator, CPU
    torch.Generator) for explicit streams, both from ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    return np.random.default_rng(seed), torch.Generator().manual_seed(seed)
