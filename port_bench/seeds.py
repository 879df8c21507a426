"""Seeds derived from the run's ``--seed``: one stream a purpose."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *keys) -> int:
    """A 31-bit seed for ``keys`` (strings or ints) of the run's seed; the
    same arguments give the same seed in every process."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for k in keys:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k) & 0xFFFFFFFF)
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0] >> 1)
