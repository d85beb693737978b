"""Far-field spatialisation for the 7-mic circular array (numpy, host).

The port's own copy of the array geometry of ``css_tpu/data/spatial.py``
(``MIC_OFFSETS``, ``mic_delays``, the rFFT phase ramps): a plane wave
from azimuth theta reaches mic m with a fractional delay
radius * cos(theta + offset_m) / c, applied exactly in the rFFT domain.
The sign matches ``executor/doa.steervec_7ch``, so a source projects
most on the steering vector at its own azimuth. Channel 0 (the centre)
has no delay: its image is the dry source.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

# mic azimuth offsets, matching the distance rows of steervec_7ch (mic 0
# is the centre)
MIC_OFFSETS = (None, math.pi / 6, -math.pi / 6, -math.pi / 2,
               -5 * math.pi / 6, 5 * math.pi / 6, math.pi / 2)


def mic_delays(azimuth_deg, radius: float = 0.0425,
               snd_velocity: float = 340.0, sr: int = 16000) -> np.ndarray:
    """Per-mic plane-wave delays in samples: azimuth scalar -> (7,),
    azimuths (B,) -> (B, 7)."""
    a = np.deg2rad(np.asarray(azimuth_deg, np.float64))[..., None]
    offs = np.array(MIC_OFFSETS[1:])
    d = np.concatenate(
        [np.zeros(a.shape), radius * np.cos(a + offs)], axis=-1)
    return d / snd_velocity * sr


def spatialize(srcs: np.ndarray, azimuths_deg: Sequence[float],
               noise_level: float = 0.0,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(K, N) dry sources at ``azimuths_deg`` -> (7, N) float32 array
    mixture: each source's image by exact fractional delays (the phase
    advance exp(+j 2 pi k delta / nfft) on its rFFT), summed, plus white
    sensor noise of standard deviation ``noise_level`` from ``rng``."""
    srcs = np.asarray(srcs, np.float64)
    n = srcs.shape[-1]
    nfft = 1 << (n - 1).bit_length()
    spec = np.fft.rfft(srcs, nfft)  # (K, F)
    deltas = mic_delays(np.asarray(azimuths_deg, np.float64))  # (K, 7)
    k = np.arange(spec.shape[-1])
    ramp = np.exp(1j * 2.0 * np.pi * k[None, None, :]
                  * deltas[:, :, None] / nfft)  # (K, 7, F)
    images = np.fft.irfft(spec[:, None, :] * ramp, nfft)[..., :n]
    out = images.sum(axis=0).astype(np.float32)
    if noise_level > 0:
        out += noise_level * rng.standard_normal(out.shape).astype(np.float32)
    return out
