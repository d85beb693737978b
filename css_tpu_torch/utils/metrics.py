"""Separation-quality metrics on the host (port of
``css_tpu/utils/metrics.py``): SI-SNR, its permutation-invariant form,
and SI-SNR improvement, in float64 numpy."""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np


def si_snr_db(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SNR in dB between two mono signals (the shorter
    length of the two)."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    est = est - est.mean()
    ref = ref - ref.mean()
    proj = (est @ ref) / (ref @ ref + eps) * ref
    noise = est - proj
    return float(10.0 * np.log10((proj @ proj) / (noise @ noise + eps) + eps))


def pit_si_snr_db(ests: Sequence[np.ndarray],
                  refs: Sequence[np.ndarray]) -> float:
    """The best mean SI-SNR over the output/reference permutations."""
    k = len(refs)
    best = -np.inf
    for perm in itertools.permutations(range(k)):
        val = np.mean([si_snr_db(ests[perm[i]], refs[i]) for i in range(k)])
        best = max(best, val)
    return float(best)


def si_snr_improvement_db(ests: Sequence[np.ndarray],
                          refs: Sequence[np.ndarray],
                          mix: np.ndarray) -> float:
    """SI-SNRi: PIT SI-SNR of the estimates minus SI-SNR of the mixture."""
    base = np.mean([si_snr_db(mix, r) for r in refs])
    return pit_si_snr_db(ests, refs) - float(base)
