"""Deterministic seeding across python/numpy/PyTorch.

Port of ``pmarlo_tpu/utils/seed.py``: where the JAX version returns the
root PRNG key of the run, this one returns a seeded ``torch.Generator``.
"""

from __future__ import annotations

import random
from typing import Any, Mapping, Optional

import numpy as np
import torch


def set_global_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed python and numpy RNGs and return a ``torch.Generator`` on
    ``device`` for the rest. All tensor randomness of a run derives from
    it, so runs are reproducible; torch's global generator is left alone."""
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed)!r}")
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def choose_sim_seed(config_seed: Optional[int] = None) -> int:
    """Pick a simulation seed: explicit config wins, else random 31-bit."""
    if config_seed is not None:
        return int(config_seed)
    return int(np.random.SeedSequence().entropy % (2**31 - 1))


def extract_seed(obj: Any, default: Optional[int] = None) -> Optional[int]:
    """Pull a seed out of a config-ish object (attr or mapping key)."""
    if obj is None:
        return default
    if isinstance(obj, Mapping) and "seed" in obj:
        value = obj["seed"]
    else:
        value = getattr(obj, "seed", default)
    if value is None:
        return default
    return int(value)


__all__ = ["set_global_seed", "choose_sim_seed", "extract_seed"]
