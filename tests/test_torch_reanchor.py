"""css_tpu_torch.executor.reanchor against css_tpu.executor.reanchor.

The same numpy streams go through both; the port is the reference's
numpy code, so the streams must be equal bit for bit and the swap counts
equal. The sessions mirror tests/test_reanchor.py: a single flip, no
flip, indistinguishable voices (the confidence gate), a flip and a flip
back, and a rotation of three streams.
"""

import numpy as np
import pytest

from css_tpu.executor.reanchor import reanchor_streams as jax_reanchor
from css_tpu_torch.executor.reanchor import reanchor_streams

SR = 16000
SEG, GAP = 3 * SR, SR


def _voice(rng, n, center_hz, width_hz=300.0):
    """Band-limited noise 'speaker' with a distinctive spectral centroid."""
    white = rng.standard_normal(n + SR).astype(np.float32)
    spec = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(len(white), 1.0 / SR)
    spec *= np.exp(-0.5 * ((freqs - center_hz) / width_hz) ** 2)
    out = np.fft.irfft(spec)[:n].astype(np.float32)
    return out / (np.abs(out).max() + 1e-9) * 0.5


def _session(seed, voices, n_seg, seg=SEG, gap=GAP):
    """Clean streams: every speaker talks in every segment, segments
    separated by a joint-silence gap."""
    rng = np.random.default_rng(seed)
    total = n_seg * (seg + gap)
    clean = [np.zeros(total, np.float32) for _ in voices]
    for i in range(n_seg):
        s = i * (seg + gap)
        for k, hz in enumerate(voices):
            clean[k][s : s + seg] = _voice(rng, seg, hz)
    return clean


def _cut(i, seg=SEG, gap=GAP):
    """A sample inside the i-th gap."""
    return i * (seg + gap) - gap // 2


def _flipped(clean, lo, hi, order):
    """clean with the streams permuted by order over [lo, hi)."""
    out = [c.copy() for c in clean]
    for k, src in enumerate(order):
        out[k][lo:hi] = clean[src][lo:hi]
    return out


CASES = {
    "single_flip": (lambda: _session(0, [500.0, 2500.0], 6),
                    lambda c: _flipped(c, _cut(2), None, [1, 0]), 1),
    "no_flip": (lambda: _session(0, [500.0, 2500.0], 6), lambda c: c, 0),
    "identical_voices": (lambda: _session(1, [1200.0, 1200.0], 4, seg=2 * SR),
                         lambda c: c, 0),
    "double_flip": (lambda: _session(2, [500.0, 2500.0], 6),
                    lambda c: _flipped(c, _cut(2), _cut(4), [1, 0]), 2),
    "three_stream_rotation": (
        lambda: _session(3, [500.0, 1500.0, 3200.0], 4),
        lambda c: _flipped(c, _cut(2), None, [1, 2, 0]), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reanchor_matches_reference(case):
    make, perturb, want_swaps = CASES[case]
    clean = make()
    streams = perturb(clean)
    want, want_n = jax_reanchor([s.copy() for s in streams], sr=SR)
    got, n = reanchor_streams([s.copy() for s in streams], sr=SR)
    assert n == want_n == want_swaps
    assert len(got) == len(want) == len(clean)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    if case != "identical_voices":  # the repair restores the clean streams
        for g, c in zip(got, clean):
            np.testing.assert_allclose(g, c, atol=1e-6)


@pytest.mark.parametrize("block_sec", [4.0, (8.0, 5.0)])
def test_reanchor_block_schedules_match(block_sec):
    """One block length and a coarse-to-fine schedule of two."""
    clean = _session(2, [500.0, 2500.0], 6)
    streams = _flipped(clean, _cut(2), _cut(4), [1, 0])
    want, want_n = jax_reanchor([s.copy() for s in streams], sr=SR,
                                block_sec=block_sec)
    got, n = reanchor_streams([s.copy() for s in streams], sr=SR,
                              block_sec=block_sec)
    assert n == want_n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
