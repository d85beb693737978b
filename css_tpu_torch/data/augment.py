"""Host-side waveform augmentations: RIR reverb and additive noise (copy
of ``css_tpu/data/augment.py``).

Reverb with a random impulse response at p=0.5 with output energy
normalisation, and noise at a uniform SNR in [min_snr, max_snr] at p=0.5,
both applied to the mixture windows only. ``use_native`` switches each to
the port's build of the native core (``ops/native.py``). It is off by
default for both: for reverb as in the JAX package (scipy's FFT is faster
than the core's radix-2 one), and for noise too, where the JAX package
defaults it on, so that the port's default batches stay bit-equal to the
JAX package's numpy path (the core sums the powers in float64, numpy in
float32). Where the core is unavailable the numpy path runs, and the
fall-back is counted in ``native.fallbacks``.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np
from scipy.signal import fftconvolve

from css_tpu_torch.ops import native

# the native core caches each RIR's spectrum per process under an integer
# id: every pool gets its own range of ids, so two pools never share one
_POOL_IDS = itertools.count()


class ReverbWithImpulseResponse:
    def __init__(self, rir_pool: List[np.ndarray], p: float = 0.5,
                 normalize_output: bool = True, use_native: bool = False):
        self.rir_pool = rir_pool
        self.p = p
        self.normalize_output = normalize_output
        self.want_native = use_native
        self.use_native = use_native and native.available()
        self._id_base = next(_POOL_IDS) << 20

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
        if self.use_native:
            return native.fft_convolve_trunc(
                wav, rir, normalize=self.normalize_output,
                rir_id=self._id_base + idx)
        if self.want_native:
            native.count_fallback()
        out = fftconvolve(wav, rir)[: len(wav)].astype(np.float32)
        if self.normalize_output:
            in_e = np.sqrt(np.mean(wav ** 2) + 1e-16)
            out_e = np.sqrt(np.mean(out ** 2) + 1e-16)
            out = out * (in_e / out_e)
        return out


class NoiseMix:
    """Additive noise at a random SNR (lhotse CutMix semantics)."""

    def __init__(self, noise_pool: List[np.ndarray], p: float = 0.5,
                 min_snr: float = 5.0, max_snr: float = 20.0,
                 use_native: bool = False):
        self.noise_pool = noise_pool
        self.p = p
        self.min_snr = min_snr
        self.max_snr = max_snr
        self.want_native = use_native
        self.use_native = use_native and native.available()

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
        if self.use_native:
            return native.add_noise_snr(wav, noise, start, snr)
        if self.want_native:
            native.count_fallback()
        if len(noise) >= n:
            noise = noise[start : start + n]
        else:
            reps = -(-n // len(noise))
            noise = np.tile(noise, reps)[:n]
        sig_p = np.mean(wav ** 2) + 1e-12
        noi_p = np.mean(noise ** 2) + 1e-12
        scale = np.sqrt(sig_p / (noi_p * 10.0 ** (snr / 10.0)))
        return (wav + scale * noise).astype(np.float32)
