"""Synthetic continuous-conversation sessions, LibriCSS-style (port of
``css_tpu/data/sessions.py``, numpy).

Utterances rotate over K speakers, and each next utterance starts a
random fraction of the previous one's length before it ends. The held-out
probe (``trainer/probe.py``) separates a few such sessions every epoch.
From the same corpus and rng the sessions are bit-equal to the JAX
package's.
"""

from __future__ import annotations

import numpy as np


def make_session(corpus, rng, dur_sec: float, sr: int = 16000,
                 overlap_frac: float = 0.3, pair=None, num_spk: int = 2,
                 with_info: bool = False):
    """One continuous K-speaker conversation of ``dur_sec`` seconds.

    Each next utterance starts ``overlap_frac`` of the previous one's
    length before the previous one ends, jittered per turn (uniform in
    [0, 2 overlap_frac), at most 0.95). ``pair`` forces the speakers; the
    rng is consumed the same way with and without it. The start may step
    backwards after a long utterance followed by a short one (pile-ups);
    a turn bound ends the walk. Returns (mix (T,), srcs (K, T)) float32,
    and with ``with_info`` the spoken Utterances in turn order.
    """
    spk = rng.choice(corpus.speakers, num_spk, replace=False)
    if pair is not None:
        spk = list(pair)
    n = int(dur_sec * sr)
    srcs = np.zeros((num_spk, n), np.float32)
    spoken = []
    pos = 0
    turn = 0
    prev_len = 0
    while pos < n:
        utts = corpus.by_speaker[spk[turn % num_spk]]
        utt = utts[rng.integers(len(utts))]
        wav = utt.load()
        spoken.append(utt)
        ov = min(rng.uniform(0.0, 2 * overlap_frac), 0.95)
        start = max(0, pos - int(ov * prev_len))
        end = min(n, start + len(wav))
        srcs[turn % num_spk, start:end] += wav[: end - start]
        prev_len = len(wav)
        pos = start + len(wav)
        turn += 1
        if turn > 100 * max(int(dur_sec), 1):
            break
    mix = srcs.sum(axis=0)
    if with_info:
        return mix, srcs, spoken
    return mix, srcs
