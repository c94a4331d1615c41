"""Seeds derived from a run's ``--seed``: the same seed and tags give the
same numbers on every machine."""

from __future__ import annotations

import numpy as np


def derive(seed: int, *tags: int) -> int:
    """A 62-bit seed from ``seed`` (any whole number below 2^64) and
    integer ``tags``."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                 (int(seed) >> 32) & 0xFFFFFFFF,
                                 *[int(t) for t in tags]])
    lo, hi = ss.generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) >> 2


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))
