"""Toy "ASR" for the synthetic corpus: pitch-token decoding (port of
``css_tpu/cli/toy_asr.py``, numpy only).

``SyntheticCorpus`` utterances are sequences of constant-pitch syllables,
and each records its transcript as 2-semitone pitch-bucket tokens
(``data/corpus.py``). The decoder recovers that token sequence from the
audio alone:

  1. frame-level f0 by normalised autocorrelation (40 ms frames, 10 ms
     hop, 60-600 Hz, parabolic interpolation, the smallest lag near the
     maximum against octave errors);
  2. a voicing gate: frame RMS against the track's 95th percentile, and a
     periodicity threshold;
  3. segments: voiced runs split where adjacent frames jump by more than
     one semitone or the envelope dips; runs under 60 ms are dropped;
  4. one token per segment from its median f0.

It scores the synthetic corpus only, and serves as the ``cli.wer`` hook:

    python -m css_tpu_torch.cli.wer --estimates out/ \\
        --references refs.jsonl \\
        --asr-cmd 'python -m css_tpu_torch.cli.toy_asr {wav}'
"""

from __future__ import annotations

import argparse

import numpy as np

FRAME_SEC = 0.040
HOP_SEC = 0.010
F0_MIN, F0_MAX = 60.0, 600.0
MIN_SEG_SEC = 0.06
VOICING_MIN_PERIODICITY = 0.35
VOICING_REL_RMS = 0.05  # of the 95th-percentile frame RMS


def frame_f0_track(wav: np.ndarray, sr: int = 16000):
    """(n_frames,) f0 in Hz (0 = unvoiced) + per-frame RMS."""
    wav = np.asarray(wav, np.float64).reshape(-1)
    flen = int(FRAME_SEC * sr)
    hop = int(HOP_SEC * sr)
    if wav.shape[0] < flen:
        wav = np.pad(wav, (0, flen - wav.shape[0]))
    starts = np.arange(0, wav.shape[0] - flen + 1, hop)
    frames = wav[starts[:, None] + np.arange(flen)[None, :]]
    frames = frames - frames.mean(axis=1, keepdims=True)
    rms = np.sqrt(np.mean(frames**2, axis=1) + 1e-12)

    lag_min = int(sr / F0_MAX)
    lag_max = min(int(sr / F0_MIN), flen - 1)
    # normalized autocorrelation via rFFT (all frames at once)
    nfft = 1 << int(np.ceil(np.log2(2 * flen)))
    spec = np.fft.rfft(frames, nfft)
    ac = np.fft.irfft(spec * np.conj(spec), nfft)[:, : lag_max + 1]
    ac0 = np.maximum(ac[:, 0], 1e-12)
    nac = ac / ac0[:, None]

    band = nac[:, lag_min : lag_max + 1]
    peak = band.max(axis=1)
    # octave guard: take the SMALLEST lag whose nac is within 10% of the
    # max (the true period's multiples score nearly as high)
    good = band >= (peak[:, None] - 0.1)
    first = np.argmax(good, axis=1)
    lags = (first + lag_min).astype(np.float64)
    # parabolic interpolation around the chosen lag
    li = (first + lag_min).clip(1, lag_max - 1)
    y0 = nac[np.arange(len(li)), li - 1]
    y1 = nac[np.arange(len(li)), li]
    y2 = nac[np.arange(len(li)), li + 1]
    denom = y0 - 2 * y1 + y2
    shift = np.where(np.abs(denom) > 1e-9, 0.5 * (y0 - y2) / denom, 0.0)
    lags = li + np.clip(shift, -1, 1)
    f0 = sr / np.maximum(lags, 1.0)

    voiced = (peak >= VOICING_MIN_PERIODICITY) & (
        rms >= VOICING_REL_RMS * np.percentile(rms, 95))

    # fine envelope at the frame grid: RMS of the CENTER 10 ms of each
    # frame — syllable boundaries are true envelope zeros (hanning^0.5
    # attack/decay, data/corpus.py), so adjacent SAME-pitch syllables are
    # separable by the dip even when the pitch track is continuous
    half = int(0.005 * sr)
    centers = starts + flen // 2
    fine = wav[np.clip(centers[:, None] + np.arange(-half, half)[None, :],
                       0, wav.shape[0] - 1)]
    env = np.sqrt(np.mean(fine**2, axis=1) + 1e-12)
    return np.where(voiced, f0, 0.0), env


def _dip_splits(env: np.ndarray) -> np.ndarray:
    """Boolean per frame: envelope local minimum far below both
    neighborhoods (a syllable-boundary dip)."""
    n = env.shape[0]
    dips = np.zeros(n, bool)
    for t in range(1, n - 1):
        if env[t] > env[t - 1] or env[t] > env[t + 1]:
            continue
        left = env[max(0, t - 4) : t].max() if t else 0.0
        right = env[t + 1 : t + 5].max() if t + 1 < n else 0.0
        if env[t] < 0.5 * min(left, right):
            dips[t] = True
    return dips


def decode_tokens(wav: np.ndarray, sr: int = 16000):
    """Audio -> pitch-token sequence (the synthetic corpus's transcript
    vocabulary, data/corpus.py)."""
    f0, env = frame_f0_track(wav, sr)
    semis = np.where(f0 > 0, 12.0 * np.log2(np.maximum(f0, 1.0) / 55.0), 0.0)
    dips = _dip_splits(env)
    min_frames = max(int(MIN_SEG_SEC / HOP_SEC), 1)
    tokens = []
    seg = []

    def emit():
        if len(seg) >= min_frames:
            tokens.append("W%d" % round(np.median(seg) / 2))
        seg.clear()

    for v, s, d in zip(f0 > 0, semis, dips):
        if d or not v or (seg and abs(s - seg[-1]) > 1.0):
            emit()
        if v and not d:
            seg.append(s)
    emit()
    return tokens


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("wav", help="audio file to transcribe")
    args = parser.parse_args(argv)
    from css_tpu_torch.data.wav_io import read_wav

    wav, sr = read_wav(args.wav)
    if wav.ndim > 1:
        wav = wav[0]
    print(" ".join(decode_tokens(wav, sr)))


if __name__ == "__main__":
    main()
