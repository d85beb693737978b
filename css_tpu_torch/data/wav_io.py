"""PCM wav I/O on the stdlib ``wave`` module (copy of
css_tpu/data/corpus.py:read_wav/write_wav)."""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str):
    """Load a (mono or multichannel) PCM wav as float32 in [-1, 1]:
    (N,) for mono, (C, N) otherwise, and the sample rate."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    data = data.reshape(-1, ch).T  # (C, N)
    return (data[0] if ch == 1 else data), sr


def write_wav(path: str, data: np.ndarray, sr: int = 16000):
    """Write float32 audio (N,) or (C, N) as 16-bit PCM wav."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None]
    pcm = np.clip(data.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(data.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
