"""Host-side waveform augmentations: RIR reverb and additive noise (copy
of the numpy path of ``css_tpu/data/augment.py``).

Reverb with a random impulse response at p=0.5 with output energy
normalisation, and noise at a uniform SNR in [min_snr, max_snr] at p=0.5,
both applied to the mixture windows only. The JAX package's native
(``mixcore.cpp``) switch waits for the port's own build of that core
(ROADMAP.md).
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.signal import fftconvolve


class ReverbWithImpulseResponse:
    def __init__(self, rir_pool: List[np.ndarray], p: float = 0.5,
                 normalize_output: bool = True):
        self.rir_pool = rir_pool
        self.p = p
        self.normalize_output = normalize_output

    def sample(self, rng: np.random.Generator, n: int):
        """Draw this transform's decision (or None): the RIR index.

        Split from ``apply`` so a recipe sampler can record decisions
        without touching audio (device-side materialization); the rng
        call order matches the fused ``__call__`` path exactly.
        """
        if rng.uniform() >= self.p:
            return None
        return int(rng.integers(len(self.rir_pool)))

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return self.apply(wav, self.sample(rng, len(wav)))

    def apply(self, wav: np.ndarray, idx) -> np.ndarray:
        if idx is None:
            return wav
        rir = self.rir_pool[idx]
        out = fftconvolve(wav, rir)[: len(wav)].astype(np.float32)
        if self.normalize_output:
            in_e = np.sqrt(np.mean(wav ** 2) + 1e-16)
            out_e = np.sqrt(np.mean(out ** 2) + 1e-16)
            out = out * (in_e / out_e)
        return out


class NoiseMix:
    """Additive noise at a random SNR (lhotse CutMix semantics)."""

    def __init__(self, noise_pool: List[np.ndarray], p: float = 0.5,
                 min_snr: float = 5.0, max_snr: float = 20.0):
        self.noise_pool = noise_pool
        self.p = p
        self.min_snr = min_snr
        self.max_snr = max_snr

    def sample(self, rng: np.random.Generator, n: int):
        """Decision tuple (noise_idx, start, snr) or None; rng order matches
        the fused ``__call__`` path (start is drawn only when the noise cut
        is at least window-length, as before)."""
        if rng.uniform() >= self.p:
            return None
        idx = int(rng.integers(len(self.noise_pool)))
        noise = self.noise_pool[idx]
        start = (int(rng.integers(0, len(noise) - n + 1))
                 if len(noise) >= n else 0)
        snr = float(rng.uniform(self.min_snr, self.max_snr))
        return idx, start, snr

    def __call__(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return self.apply(wav, self.sample(rng, len(wav)))

    def apply(self, wav: np.ndarray, decision) -> np.ndarray:
        if decision is None:
            return wav
        idx, start, snr = decision
        noise = self.noise_pool[idx]
        n = len(wav)
        if len(noise) >= n:
            noise = noise[start : start + n]
        else:
            reps = -(-n // len(noise))
            noise = np.tile(noise, reps)[:n]
        sig_p = np.mean(wav ** 2) + 1e-12
        noi_p = np.mean(noise ** 2) + 1e-12
        scale = np.sqrt(sig_p / (noi_p * 10.0 ** (snr / 10.0)))
        return (wav + scale * noise).astype(np.float32)
