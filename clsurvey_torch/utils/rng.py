"""Deterministic randomness (ref:src/utilities/utils.py:52-58 ``set_random``).

Counterpart of ``clsurvey_tpu/utils/rng.py``. Seeds Python's, numpy's and
torch's global generators the way the reference does. The port's own random
draws (epoch permutations, flip masks, head inits) come from explicit
``torch.Generator``s made by :func:`generator`, never from global state."""

from __future__ import annotations

import random

import numpy as np
import torch

DEFAULT_SEED = 7


def set_random(seed: int = DEFAULT_SEED) -> int:
    """Reset the global RNG streams deterministically; returns the seed."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def generator(*seeds: int, device="cpu") -> torch.Generator:
    """A private generator on ``device`` seeded from a tuple of integers
    (e.g. (run seed, epoch)), the analog of ``jax.random.fold_in``."""
    mixed = 0
    for s in seeds:
        mixed = (mixed * 1_000_003 + int(s)) % (2**63)
    return torch.Generator(device=device).manual_seed(mixed)
