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
``noise`` (standard deviation), ``level`` (a turn's peak).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


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
    noise = torch.randn(n, generator=gen, device=device) * p["noise"]
    return srcs.sum(0) + noise
