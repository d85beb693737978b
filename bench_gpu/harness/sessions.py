"""Multi-talker sessions from a seed, synthesised on the device.

A session is a conversation of alternating talkers: each turn a
formant-filtered harmonic voice (slow pitch drift, a syllable-rate
envelope) that starts up to ``overlap`` of its length before the previous
turn ends, plus low white noise; every session of a mix has the same
length, so every seed gives the same shapes. The turn plan (a few scalars
a turn) comes from numpy's generator, the waveforms from torch on the
device, so a 10-minute session takes milliseconds.

Parameters (a traffic file's ``session`` object): ``seconds``,
``sample_rate``, ``voices`` ([f0, [formant Hz, ...]] per talker),
``turn_seconds`` [lo, hi], ``overlap`` [lo, hi] (share of a turn),
``noise`` (standard deviation), ``level`` (a turn's peak). For an array
recording, ``mics`` ([x, y] metres a channel, channel 0 first) and
``azimuths`` (degrees a talker): each talker reaches each microphone as a
plane wave from its azimuth in free field (a delay in the frequency
domain), with independent noise a channel; without ``mics`` a session is
one channel.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

SOUND_M_S = 343.0  # the speed of sound, m/s


def _turn(rng, f0, formants, sr, p, device) -> torch.Tensor:
    dur = int(rng.uniform(*p["turn_seconds"]) * sr)
    drift_hz, drift_ph = rng.uniform(0.2, 0.6), rng.uniform(0, 6.3)
    env_hz, env_ph = rng.uniform(3.0, 5.0), rng.uniform(0, 6.3)
    t = torch.arange(dur, device=device, dtype=torch.float64) / sr
    inst_f0 = f0 * (1.0 + 0.08 * torch.sin(2 * math.pi * drift_hz * t
                                           + drift_ph))
    phase = 2 * math.pi * torch.cumsum(inst_f0, 0) / sr
    harm = torch.arange(1, int(4000 // f0), device=device,
                        dtype=torch.float64)
    fh = harm * f0
    gain = sum(1.0 / (1.0 + ((fh - fc) / 120.0) ** 2) for fc in formants)
    gain = gain / torch.sqrt(harm)
    wav = (gain[:, None] * torch.sin(harm[:, None] * phase[None])).sum(0)
    env = torch.clamp(torch.sin(2 * math.pi * env_hz * t + env_ph),
                      min=0.0) ** 0.7
    wav = wav * env
    return (wav / (wav.abs().max() + 1e-9) * p["level"]).float()


def session(p: Dict, seed: int, index: int, device) -> torch.Tensor:
    """Session ``index`` of seed ``seed``: the mixture (T,), float32 on
    ``device``."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), int(index)])
    sr = int(p["sample_rate"])
    n = int(p["seconds"] * sr)
    voices = p["voices"]
    srcs = torch.zeros((len(voices), n), device=device)
    pos = turn = 0
    while pos < n:
        f0, formants = voices[turn % len(voices)]
        wav = _turn(rng, float(f0), formants, sr, p, device)
        dur = wav.shape[0]
        start = max(0, pos - int(rng.uniform(*p["overlap"]) * dur))
        end = min(n, start + dur)
        srcs[turn % len(voices), start:end] += wav[:end - start]
        pos, turn = start + dur, turn + 1
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 62)))
    if not p.get("mics"):
        noise = torch.randn(n, generator=gen, device=device) * p["noise"]
        return srcs.sum(0) + noise
    mix = _array(srcs, p["mics"], p["azimuths"], sr)
    noise = torch.randn(mix.shape, generator=gen, device=device) * p["noise"]
    return mix + noise


def _array(srcs: torch.Tensor, mics, azimuths, sr: int) -> torch.Tensor:
    """Talkers (V, T) -> the array's channels (C, T): talker v reaches
    the microphone at r after -(r . u_v) / c seconds, u_v its unit
    direction."""
    dev, n = srcs.device, srcs.shape[-1]
    pos = torch.tensor(mics, dtype=torch.float64, device=dev)
    az = torch.deg2rad(torch.tensor(azimuths, dtype=torch.float64,
                                    device=dev))
    tau = -(pos @ torch.stack([torch.cos(az), torch.sin(az)])) / SOUND_M_S
    spec = torch.fft.rfft(srcs, n=n)
    freqs = torch.fft.rfftfreq(n, 1.0 / sr, dtype=torch.float64, device=dev)
    return torch.stack([
        torch.fft.irfft((spec * torch.polar(
            torch.ones_like(freqs), -2 * math.pi * freqs * tau[c, :, None])
            .to(spec.dtype)).sum(0), n=n)
        for c in range(pos.shape[0])])
