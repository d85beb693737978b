"""Corpora: utterance inventories with a speaker index, and the synthetic
corpus and augmentation pools (copy of ``css_tpu/data/corpus.py``; wav I/O
is ``data/wav_io.py``).

A corpus is a list of utterances with speakers; audio is numpy on the
host. ``SyntheticCorpus``, ``synthetic_rir_pool`` and
``synthetic_noise_pool`` make the same arrays as the JAX package's from
the same seeds (tests/test_torch_train_data.py holds them bit-equal).
"""

from __future__ import annotations

import json
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from css_tpu_torch.data.wav_io import read_wav


@dataclass
class Utterance:
    utt_id: str
    speaker: str
    duration: float  # seconds
    path: Optional[str] = None  # wav on disk ...
    array: Optional[np.ndarray] = None  # ... or in-memory audio
    sample_rate: int = 16000
    text: Optional[str] = None  # transcript (synthetic: pitch tokens)

    def load(self) -> np.ndarray:
        if self.array is not None:
            return self.array
        return read_wav(self.path)[0]

    def num_samples(self) -> int:
        """Exact sample count without decoding audio (wav header read)."""
        if self.array is not None:
            return len(self.array)
        with wave.open(str(self.path), "rb") as w:
            return w.getnframes()


class Corpus:
    """An utterance inventory with a speaker index."""

    def __init__(self, utterances: Sequence[Utterance]):
        self.utterances: List[Utterance] = list(utterances)
        self.by_speaker: Dict[str, List[Utterance]] = {}
        for u in self.utterances:
            self.by_speaker.setdefault(u.speaker, []).append(u)
        self.speakers = sorted(self.by_speaker)
        if self.utterances:
            self.sample_rate = self.utterances[0].sample_rate

    def __len__(self):
        return len(self.utterances)

    @classmethod
    def from_manifest(cls, path: str) -> "Corpus":
        """Load a jsonl manifest: one {utt_id, speaker, duration, path} per line."""
        utts = []
        base = Path(path).parent
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                p = Path(rec["path"])
                if not p.is_absolute():
                    p = base / p
                utts.append(Utterance(
                    utt_id=rec["utt_id"], speaker=rec["speaker"],
                    duration=float(rec["duration"]), path=str(p),
                    sample_rate=int(rec.get("sample_rate", 16000))))
        return cls(utts)

    def to_manifest(self, path: str):
        with open(path, "w") as f:
            for u in self.utterances:
                f.write(json.dumps({
                    "utt_id": u.utt_id, "speaker": u.speaker,
                    "duration": u.duration, "path": u.path,
                    "sample_rate": u.sample_rate}) + "\n")


class SyntheticCorpus(Corpus):
    """Deterministic synthetic speech-like corpus (no external data needed).

    Utterances are amplitude-modulated harmonic tones with per-speaker
    fundamentals plus filtered noise — enough spectral structure for the
    separation objective to be meaningful in tests and benchmarks.

    Two voice models:

    - ``voice="harmonic"`` (legacy, default): per-syllable RANDOM harmonic
      weights — speaker identity is essentially the base f0 alone. Two
      speakers with close fundamentals are then inseparable by timbre no
      matter how good the mask model is (measured: the two close-f0
      sessions of the 8-session held-out protocol collapse to negative
      SI-SNRi while the IRM oracle still scores +10 dB — the oracle sees
      the per-frame energy ratio, which no causal-free magnitude model can
      recover without a speaker-identity cue).
    - ``voice="formant"``: each speaker gets a persistent vocal-tract
      signature — 3 formant resonances + spectral tilt + breathiness —
      jittered per syllable (coarticulation) but stable in expectation,
      like a real talker's timbre (LibriSpeech speakers differ in vocal
      tract, not just pitch). This makes close-f0 pairs separable in
      principle and is the more faithful stand-in for the reference's
      LibriSpeech training material (css/datasets/separation.py mixes
      real speakers).
    """

    def __init__(self, num_speakers: int = 8, utts_per_speaker: int = 6,
                 min_dur: float = 3.0, max_dur: float = 8.0,
                 sample_rate: int = 16000, seed: int = 0,
                 f0_min: float = 90.0, f0_max: float = None,
                 voice: str = "harmonic"):
        if voice not in ("harmonic", "formant"):
            raise ValueError(f"unknown voice model {voice!r}")
        rng = np.random.default_rng(seed)
        # default ladder: 25 Hz per speaker (historical). Passing f0_max
        # packs the same speaker count into [f0_min, f0_max] — a DENSER
        # fundamental grid. Speaker identity in this corpus is essentially
        # the base f0, so a sparse ladder lets a mask model key on the
        # exact trained fundamentals and fail on held-out speakers between
        # them (measured: +7.5 dB SI-SNRi in-distribution vs +0.1 held-out
        # with the 25 Hz ladder); a dense grid forces interpolation.
        spacing = (25.0 if f0_max is None
                   else (f0_max - f0_min) / max(num_speakers - 1, 1))
        utts = []
        self.f0_by_speaker: Dict[str, float] = {}
        for s in range(num_speakers):
            base_f0 = f0_min + spacing * s + rng.uniform(-5, 5)
            self.f0_by_speaker[f"spk{s}"] = float(base_f0)
            if voice == "formant":
                # Persistent per-speaker vocal tract: 3 resonances with
                # speaker-specific centers/bandwidths/gains, spectral tilt,
                # and a breathiness level. Drawn once per speaker.
                formants = np.array([
                    rng.uniform(320.0, 850.0),
                    rng.uniform(950.0, 2300.0),
                    rng.uniform(2400.0, 3400.0)])
                form_bw = rng.uniform(70.0, 180.0, 3)
                form_gain = rng.uniform(0.5, 1.0, 3)
                tilt = rng.uniform(0.4, 1.2)  # amp ~ (f/300)^-tilt above 300
                breath = rng.uniform(0.02, 0.08)
            for u in range(utts_per_speaker):
                dur = float(rng.uniform(min_dur, max_dur))
                n = int(dur * sample_rate)
                # Speech-like time-frequency SPARSITY matters: steady tones
                # collide in single STFT bins and defeat mask-based
                # separation regardless of model quality (phase pathology),
                # so utterances are sequences of short "syllables" with a
                # hopping pitch and hopping formant-like harmonic weights.
                sig = np.zeros(n, np.float32)
                tokens = []  # per-syllable pitch tokens = the transcript
                pos = 0
                while pos < n:
                    seg_len = int(rng.uniform(0.15, 0.35) * sample_rate)
                    seg_len = min(seg_len, n - pos)
                    t = np.arange(seg_len) / sample_rate
                    if voice == "harmonic":
                        f0 = base_f0 * 2.0 ** rng.uniform(-0.3, 0.3)
                        seg = np.zeros(seg_len, np.float64)
                        weights = rng.uniform(0.2, 1.0, 8) / np.arange(1, 9)
                        for h in range(1, 9):
                            if f0 * h < sample_rate / 2 - 200:
                                seg += weights[h - 1] * np.sin(
                                    2 * np.pi * f0 * h * t + rng.uniform(0, 6))
                    else:
                        f0 = base_f0 * 2.0 ** rng.uniform(-0.25, 0.25)
                        h_max = min(int((sample_rate / 2 - 200) // f0), 60)
                        freqs = f0 * np.arange(1, h_max + 1)
                        # per-syllable formant jitter (coarticulation) around
                        # the speaker's persistent resonances
                        cent = formants * 2.0 ** rng.uniform(-0.08, 0.08, 3)
                        amp = np.full(h_max, 0.05)
                        for fk, bk, gk in zip(cent, form_bw, form_gain):
                            amp += gk * bk ** 2 / ((freqs - fk) ** 2 + bk ** 2)
                        amp *= (np.maximum(freqs, 300.0) / 300.0) ** (-tilt)
                        phases = rng.uniform(0, 2 * np.pi, h_max)
                        seg = np.sin(
                            2 * np.pi * t[:, None] * freqs[None, :]
                            + phases[None, :]) @ amp
                        rms = np.sqrt(np.mean(seg * seg)) + 1e-8
                        seg *= rng.uniform(0.4, 1.0) / rms
                        # breathy aperiodic component (+6 dB/oct tilt) — a
                        # second per-speaker timbre cue beyond the resonances
                        bn = np.diff(rng.standard_normal(seg_len + 1))
                        seg += breath * bn / (np.std(bn) + 1e-8)
                    # syllable envelope (attack/decay)
                    env = np.hanning(seg_len) ** 0.5
                    # occasional silence gap
                    silent = rng.uniform() < 0.2
                    if silent:
                        seg *= 0.05
                    elif seg_len >= int(0.08 * sample_rate):
                        # transcript token: the syllable's pitch quantized
                        # to 2-semitone buckets (speaker-independent and
                        # decodable from audio — cli/toy_asr.py is the
                        # matched decoder; too-short tail syllables are
                        # skipped, the decoder can't segment them)
                        tokens.append(
                            "W%d" % round(12 * np.log2(f0 / 55.0) / 2))
                    sig[pos : pos + seg_len] = (seg * env).astype(np.float32)
                    pos += seg_len
                noise = rng.standard_normal(n).astype(np.float32)
                kernel = np.ones(8, np.float32) / 8
                noise = np.convolve(noise, kernel, mode="same")
                sig = 0.1 * sig + 0.005 * noise
                utts.append(Utterance(
                    utt_id=f"spk{s}_utt{u}", speaker=f"spk{s}",
                    duration=dur, array=sig, sample_rate=sample_rate,
                    text=" ".join(tokens)))
        super().__init__(utts)


def synthetic_rir_pool(num: int = 16, sr: int = 16000, max_len: float = 0.25,
                       seed: int = 1) -> List[np.ndarray]:
    """Exponentially decaying noise RIRs (stand-in for measured RIRS_NOISES)."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(num):
        n = int(rng.uniform(0.05, max_len) * sr)
        t60 = rng.uniform(0.1, 0.4)
        decay = np.exp(-6.9 * np.arange(n) / (t60 * sr))
        h = rng.standard_normal(n).astype(np.float32) * decay.astype(np.float32)
        h[0] = 1.0  # direct path
        pool.append(h / np.sqrt(np.sum(h * h)))
    return pool


def synthetic_noise_pool(num: int = 8, sr: int = 16000, dur: float = 4.0,
                         seed: int = 2) -> List[np.ndarray]:
    """Pink-ish noise cuts (stand-in for isotropic noise manifests)."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(num):
        n = int(dur * sr)
        white = rng.standard_normal(n).astype(np.float32)
        # crude 1/f shaping via leaky integrator
        from scipy.signal import lfilter

        a = 0.98
        pink = lfilter([1 - a], [1, -a], white).astype(np.float32)
        pink = pink / (np.std(pink) + 1e-8)
        pool.append(pink)
    return pool
