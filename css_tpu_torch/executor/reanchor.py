"""Session-level stream-identity re-anchoring (speaker tracking).

Port of ``css_tpu/executor/reanchor.py``, a host pass in numpy over the
final streams, kept close to verbatim. The stitcher routes each window
relative to the previous window's overlap; at a boundary whose overlap
evidence is weak the decision is a coin flip, and one wrong flip swaps
the output streams for the rest of the recording. Between flips the
streams are well separated for tens of seconds, so a long-term timbre
profile (the average log-spectrum over active frames) is a reliable
per-stream signature. This module:

  1. splits the session into fixed-length blocks (~seconds);
  2. computes a timbre profile per (block, stream);
  3. walks the blocks, greedily choosing the stream permutation that
     best matches the profiles accumulated so far (confidence-gated:
     ambiguous blocks keep the incoming identity and do not update the
     anchors);
  4. when a flip is detected, pinpoints the cut by a change-point scan
     around the block boundary (maximise pre/post profile consistency),
     snaps it to the quietest nearby frame, and swaps the waveforms from
     the cut onward.

No model and no device work; K-general (permutations over K streams).
Enabled with ``stitching: {reanchor: true}`` in the pipeline config.
"""

from __future__ import annotations

import itertools

import numpy as np


def _frame_rms(x: np.ndarray, hop: int) -> np.ndarray:
    """Per-frame RMS of a mono signal, frame = hop samples (no overlap)."""
    n = (x.shape[-1] // hop) * hop
    frames = x[..., :n].reshape(*x.shape[:-1], -1, hop)
    return np.sqrt(np.mean(frames**2, axis=-1) + 1e-12)


def _log_spectrum(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(T, F) log-magnitude STFT frames of a mono signal (numpy, host)."""
    n = x.shape[-1]
    if n < n_fft:
        x = np.pad(x, (0, n_fft - n))
        n = n_fft
    starts = np.arange(0, n - n_fft + 1, hop)
    idx = starts[:, None] + np.arange(n_fft)[None, :]
    frames = x[idx] * np.hanning(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=-1))
    return np.log1p(mag)


def _unit(p: np.ndarray) -> np.ndarray:
    p = p - p.mean()
    return p / (np.linalg.norm(p) + 1e-12)


class _Tracker:
    """Profile bookkeeping over original-stream spectra."""

    def __init__(self, streams, sr, n_fft, hop, active_rel_db):
        self.k = len(streams)
        self.hop = hop
        self.rms = np.stack([_frame_rms(s, hop) for s in streams])  # (K, T)
        self.total = np.sqrt(np.sum(self.rms**2, axis=0))
        self.specs = [_log_spectrum(s, n_fft, hop) for s in streams]
        self.n_frames = min(sp.shape[0] for sp in self.specs)
        ref = np.percentile(self.rms, 95)
        self.active_thresh = ref * 10.0 ** (active_rel_db / 20.0)
        self.min_active = max(4, int(0.2 * sr / hop))  # >= 0.2 s of speech

    def profile(self, ki: int, f0: int, f1: int):
        """(profile, weight) of original stream ki over frames [f0, f1)."""
        f1 = min(f1, self.n_frames)
        if f1 <= f0:
            return None, 0
        act = self.rms[ki, f0:f1] > self.active_thresh
        w = int(act.sum())
        if w < self.min_active:
            return None, 0
        return _unit(self.specs[ki][f0:f1][act].mean(0)), w


def reanchor_streams(
    streams,
    sr: int = 16000,
    n_fft: int = 512,
    hop: int = 256,
    block_sec=(8.0, 5.0, 4.0),
    confidence: float = 0.04,
    cut_scan_sec: float = 0.2,
):
    """Re-align stream identities across fixed blocks of the session.

    `block_sec` may be one block length or a coarse-to-fine schedule of
    passes (the default): the coarse pass repairs long-lived flips with
    the most reliable profiles, finer passes then catch shorter flips —
    measured on held-out sessions the multi-scale schedule beats every
    single scale on both mean and worst-session SI-SNRi. `confidence` is
    the minimum cosine-similarity margin the best permutation must have
    over the runner-up before a swap is applied (ambiguous blocks pass
    through unchanged and do not pollute the anchors).
    Returns (streams, n_swaps).
    """
    if np.ndim(block_sec) > 0:
        total = 0
        out = [np.asarray(s, np.float32) for s in streams]
        for bs in block_sec:
            out, n = _reanchor_pass(out, sr, n_fft, hop, float(bs),
                                    confidence, cut_scan_sec)
            total += n
        return out, total
    return _reanchor_pass(list(streams), sr, n_fft, hop, float(block_sec),
                          confidence, cut_scan_sec)


def _reanchor_pass(streams, sr, n_fft, hop, block_sec, confidence,
                   cut_scan_sec):
    streams = [np.asarray(s, np.float32) for s in streams]
    k = len(streams)
    if k < 2:
        return list(streams), 0
    length = min(s.shape[-1] for s in streams)
    streams = [s[:length] for s in streams]
    block = max(int(block_sec * sr / hop), 8)  # frames per block
    tr = _Tracker(streams, sr, n_fft, hop, active_rel_db=-20.0)
    bounds = list(range(0, tr.n_frames - block // 2, block))
    bounds.append(tr.n_frames)
    if len(bounds) < 3:  # fewer than two blocks: nothing to re-align
        return list(streams), 0

    perms = list(itertools.permutations(range(k)))
    ident = tuple(range(k))
    anchors = [None] * k
    anchor_w = [0.0] * k

    def absorb(profs, weights):
        for ki in range(k):
            p, w = profs[ki], weights[ki]
            if p is None:
                continue
            if anchors[ki] is None:
                anchors[ki] = p.copy()
                anchor_w[ki] = float(w)
            else:
                tot = anchor_w[ki] + w
                anchors[ki] = _unit(
                    anchors[ki] * anchor_w[ki] + p * w)
                anchor_w[ki] = tot

    def perm_score(profs):
        scores = []
        for perm in perms:
            vals = [float(np.dot(anchors[ki], profs[perm[ki]]))
                    for ki in range(k)
                    if anchors[ki] is not None and profs[perm[ki]] is not None]
            scores.append(np.mean(vals) if vals else None)
        return scores

    out = [s.copy() for s in streams]
    current = ident  # original index held by each output slot right now
    n_swaps = 0
    last_cut_frame = 0

    p0 = [tr.profile(ki, bounds[0], bounds[1]) for ki in range(k)]
    absorb([p for p, _ in p0], [w for _, w in p0])

    scan = max(1, int(cut_scan_sec * sr / hop))
    for bi in range(1, len(bounds) - 1):
        f0, f1 = bounds[bi], bounds[bi + 1]
        raw = [tr.profile(current[ki], f0, f1) for ki in range(k)]
        profs = [p for p, _ in raw]
        weights = [w for _, w in raw]
        scores = perm_score(profs)
        defined = [(sc, perm) for sc, perm in zip(scores, perms)
                   if sc is not None]
        if len(defined) < 2:
            absorb(profs, weights)
            continue
        defined.sort(key=lambda t: -t[0])
        best_score, best_perm = defined[0]
        margin = best_score - defined[1][0]
        if margin < confidence:
            continue  # ambiguous: keep identity, do not grow anchors
        if best_perm == ident:
            absorb(profs, weights)
            continue
        # flip detected. Pinpoint the cut inside [prev bound, this block
        # end): maximize identity-consistency before the cut plus
        # permuted-consistency after it (change-point scan on the frame
        # grid), then snap to the quietest frame nearby.
        lo = max(bounds[bi - 1], last_cut_frame + 1)
        hi = f1
        cands = list(range(lo + scan, hi - scan, scan))
        best_cut, best_val = f0, -np.inf
        for c in cands:
            val, tot_w = 0.0, 0
            for ki in range(k):
                p_pre, w_pre = tr.profile(current[ki], lo, c)
                if p_pre is not None and anchors[ki] is not None:
                    val += w_pre * float(np.dot(anchors[ki], p_pre))
                    tot_w += w_pre
                p_post, w_post = tr.profile(current[best_perm[ki]], c, hi)
                if p_post is not None and anchors[ki] is not None:
                    val += w_post * float(np.dot(anchors[ki], p_post))
                    tot_w += w_post
            if tot_w:
                val /= tot_w
                if val > best_val:
                    best_val, best_cut = val, c
        # snap to the quietest frame within +-0.5 s of the change point
        snap = int(0.5 * sr / hop)
        s0 = max(lo, best_cut - snap)
        s1 = min(hi, best_cut + snap + 1)
        q = s0 + int(np.argmin(tr.total[s0:s1]))
        cut = q * hop
        tail = [out[best_perm[ki]][cut:].copy() for ki in range(k)]
        for ki in range(k):
            out[ki][cut:] = tail[ki]
        current = tuple(current[best_perm[ki]] for ki in range(k))
        last_cut_frame = q
        n_swaps += 1
        # re-read this block's profiles under the new identity and absorb
        raw = [tr.profile(current[ki], max(q, f0), f1) for ki in range(k)]
        absorb([p for p, _ in raw], [w for _, w in raw])
    return out, n_swaps
