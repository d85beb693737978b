"""Static permutation tables (copy of css_tpu/ops/pit.py:permutations_array)."""

from __future__ import annotations

import itertools
import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def permutations_array(k: int) -> np.ndarray:
    """(K!, K) int32 array of all permutations of range(K); row 0 is the
    identity."""
    if k >= 10:
        raise ValueError(f"K={k} gives {math.factorial(k)} permutations; refuse")
    return np.asarray(list(itertools.permutations(range(k))), dtype=np.int32)
