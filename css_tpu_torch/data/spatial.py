"""Far-field spatialisation for the 7-mic circular array (numpy, host).

The port's own copy of ``css_tpu/data/spatial.py``: a plane wave from
azimuth theta reaches mic m with a fractional delay
radius * cos(theta + offset_m) / c, applied exactly in the rFFT domain.
The sign matches ``executor/doa.steervec_7ch``, so a source projects most
on the steering vector at its own azimuth. Channel 0 (the centre) has no
delay: its image is the dry source, which is why the dry sources are the
targets (and the SI-SNR references) of 7ch training.

``SpatialMixer`` wraps a ``MixtureSynthesizer`` into a stream of (B, 7, N)
far-field batches for ``cli.train --spatialize-channels 7``. From the same
seeds its batches are bit-equal to the JAX package's: the numpy calls and
their order are the same. The on-card rendering of the same recipes is
``data/device_mixer.materialize``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

# mic azimuth offsets, matching the distance rows of steervec_7ch (mic 0
# is the centre)
MIC_OFFSETS = (None, math.pi / 6, -math.pi / 6, -math.pi / 2,
               -5 * math.pi / 6, 5 * math.pi / 6, math.pi / 2)
RADIUS, SOUND_VELOCITY = 0.0425, 340.0


def mic_delays(azimuth_deg, radius: float = RADIUS,
               snd_velocity: float = SOUND_VELOCITY,
               sr: int = 16000) -> np.ndarray:
    """Per-mic plane-wave delays in samples: azimuth scalar -> (7,),
    azimuths (B,) -> (B, 7)."""
    a = np.deg2rad(np.asarray(azimuth_deg, np.float64))[..., None]
    offs = np.array(MIC_OFFSETS[1:])
    d = np.concatenate(
        [np.zeros(a.shape), radius * np.cos(a + offs)], axis=-1)
    return d / snd_velocity * sr


def _phase_ramps(azimuths_deg: np.ndarray, n_bins: int, nfft: int,
                 radius: float, snd_velocity: float, sr: int) -> np.ndarray:
    """(B,) azimuths -> (B, 7, n_bins) complex rFFT ramps: a phase advance
    of delta samples, exp(+j 2 pi k delta / nfft), the phase the steering
    table expects at its own azimuth."""
    deltas = mic_delays(azimuths_deg, radius, snd_velocity, sr)  # (B, 7)
    k = np.arange(n_bins)
    return np.exp(1j * 2.0 * np.pi * k[None, None, :]
                  * deltas[:, :, None] / nfft)


def _spatialize_batch(waves: np.ndarray, azimuths_deg: np.ndarray,
                      radius: float = RADIUS,
                      snd_velocity: float = SOUND_VELOCITY,
                      sr: int = 16000) -> np.ndarray:
    """(B, N) windows, (B,) azimuths -> (B, 7, N) float32 images."""
    n = waves.shape[-1]
    nfft = 1 << (n - 1).bit_length()
    spec = np.fft.rfft(waves, nfft)  # (B, F)
    ramp = _phase_ramps(azimuths_deg, spec.shape[-1], nfft,
                        radius, snd_velocity, sr)  # (B, 7, F)
    return np.fft.irfft(spec[:, None, :] * ramp, nfft)[..., :n].astype(
        np.float32)


def spatialize_7ch(wav: np.ndarray, azimuth_deg: float,
                   radius: float = RADIUS,
                   snd_velocity: float = SOUND_VELOCITY,
                   sr: int = 16000) -> np.ndarray:
    """(N,) dry source -> (7, N) far-field array image."""
    wav = np.asarray(wav, np.float64)
    return _spatialize_batch(wav[None], np.atleast_1d(azimuth_deg),
                             radius, snd_velocity, sr)[0]


def spatial_session(srcs: np.ndarray, azimuths_deg, noise_level: float = 0.0,
                    seed: int = 0, **kw) -> np.ndarray:
    """(K, N) dry sources at the given azimuths -> (7, N) array mixture,
    plus white sensor noise from ``default_rng(seed)`` when noise_level >
    0 (the JAX package's ``spatial_session``, bit for bit)."""
    out = np.zeros((7, srcs.shape[-1]), np.float32)
    for s, az in zip(srcs, azimuths_deg):
        out += spatialize_7ch(s, az, **kw)
    if noise_level > 0:
        rng = np.random.default_rng(seed)
        out += noise_level * rng.standard_normal(out.shape).astype(np.float32)
    return out


def spatialize(srcs: np.ndarray, azimuths_deg: Sequence[float],
               noise_level: float = 0.0,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(K, N) dry sources at ``azimuths_deg`` -> (7, N) float32 array
    mixture: the images summed in float64, then white sensor noise of
    standard deviation ``noise_level`` from ``rng``."""
    srcs = np.asarray(srcs, np.float64)
    n = srcs.shape[-1]
    nfft = 1 << (n - 1).bit_length()
    spec = np.fft.rfft(srcs, nfft)  # (K, F)
    ramp = _phase_ramps(np.asarray(azimuths_deg, np.float64), spec.shape[-1],
                        nfft, RADIUS, SOUND_VELOCITY, 16000)  # (K, 7, F)
    images = np.fft.irfft(spec[:, None, :] * ramp, nfft)[..., :n]
    out = images.sum(axis=0).astype(np.float32)
    if noise_level > 0:
        out += noise_level * rng.standard_normal(out.shape).astype(np.float32)
    return out


def draw_azimuths(rng: np.random.Generator, k: int,
                  min_separation_deg: float) -> np.ndarray:
    """(K,) azimuths uniform on the circle, redrawn until every two are at
    least ``min_separation_deg`` apart (talkers sit at distinct seats)."""
    while True:
        cand = rng.uniform(0.0, 360.0, k)
        d = np.abs(cand[:, None] - cand[None, :])
        d = np.minimum(d, 360.0 - d)
        if k == 1 or d[np.triu_indices(k, 1)].min() >= min_separation_deg:
            return cand


class SpatialMixer:
    """A MixtureSynthesizer's batches rendered on the 7-mic array.

    Each window's K sources get independent azimuths (``draw_azimuths``);
    the mixture is the sum of their images plus white sensor noise of
    standard deviation ``noise_level`` per channel. The targets stay the
    dry sources, the channel-0 images. The wrapped mixer must have no
    mixture transforms: reverb and noise on a mono mixture have no spatial
    image.
    """

    def __init__(self, mixer, noise_level: float = 0.003, seed: int = 0,
                 min_separation_deg: float = 20.0):
        if mixer.transforms:
            raise ValueError(
                "SpatialMixer needs a transform-free mixer (reverb/noise "
                "on a mono mixture has no spatial image); use its "
                "noise_level for sensor noise")
        self.mixer = mixer
        self.noise_level = noise_level
        self.min_separation = min_separation_deg
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def _draw_azimuths(self, b: int, k: int) -> np.ndarray:
        """(B, K) azimuths in degrees, one ``draw_azimuths`` per row."""
        az = np.empty((b, k), np.float64)
        for bi in range(b):
            az[bi] = draw_azimuths(self.rng, k, self.min_separation)
        return az

    def spatialize_batch(self, batch, az=None):
        """Render a mono batch's sources on the array: the K phase-ramped
        source spectra summed, then one irFFT (what the card does too)."""
        srcs = [batch[f"source{i + 1}"]
                for i in range(self.mixer.num_speakers)]
        b, n = srcs[0].shape
        if az is None:
            az = self._draw_azimuths(b, len(srcs))
        nfft = 1 << (n - 1).bit_length()
        acc = None
        for ki, s in enumerate(srcs):
            spec = np.fft.rfft(s, nfft)  # (B, F)
            ramp = _phase_ramps(az[:, ki], spec.shape[-1], nfft,
                                RADIUS, SOUND_VELOCITY, self.mixer.sr)
            term = spec[:, None, :] * ramp
            acc = term if acc is None else acc + term
        mix = np.fft.irfft(acc, nfft)[..., :n].astype(np.float32)
        if self.noise_level > 0:
            mix += (self.noise_level
                    * self.rng.standard_normal(mix.shape).astype(np.float32))
        out = dict(batch)
        out["mix"] = mix
        return out

    def __next__(self):
        return self.spatialize_batch(next(self.mixer))
