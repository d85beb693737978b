"""css_tpu_torch.ops.features (mvn, IPD, FeatureExtractor) against css_tpu.

Float32; the same products summed in another order: 1e-4 absolute and
relative on MVN'd features of order 1, and on spectra.

IPD values are angles, compared wrap-aware: the difference is wrapped
into (-pi, pi] before it is held to IPD_ATOL, so that a value near +-pi
that lands on the other side of the branch cut in one package counts as
the small difference it is. Entries whose centred vector (the pair's
unit phase vector minus its mean over frames) is shorter than
IPD_MIN_LENGTH are left out: there the angle is ill-defined, and a
rounding of ~1e-7 moves it by ~1e-7 / length. The angles also inherit
the phase noise of bins whose magnitude is near the STFT's rounding: on
these inputs the wrap-aware difference is at most 1.1e-3 rad (measured
on the CPU), so IPD_ATOL is 2e-3 rad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.data.spatial import spatial_session
from css_tpu.ops import features as jf
from css_tpu_torch.ops import features as tf

ATOL = RTOL = 1e-4
IPD_ATOL = 2e-3
IPD_MIN_LENGTH = 1e-2
IPD_7CH = "1,0;2,0;3,0;4,0;5,0;6,0"


def _wrapped(d):
    return np.angle(np.exp(1j * np.asarray(d, np.float64)))


def _centred_length(phase, left, right):
    """(..., M, T, F) length of each pair's centred unit phase vector, in
    float64 from the reference's phases."""
    dif = phase[..., left, :, :] - phase[..., right, :, :]
    yr, yi = np.cos(dif), np.sin(dif)
    return np.hypot(yr - yr.mean(-2, keepdims=True),
                    yi - yi.mean(-2, keepdims=True))


def _assert_ipd_close(got, want, length):
    keep = length >= IPD_MIN_LENGTH
    assert keep.mean() > 0.95  # the exclusion leaves out few entries
    err = np.abs(_wrapped(got - want))[keep]
    assert err.max() <= IPD_ATOL, err.max()


def _windows_7ch(seed, n=38656, batch=3):
    """(batch, 7, n): two noise sources at 40 and 200 degrees on the
    7-mic array with 0.003 sensor noise, and a window of 7 independent
    noise channels."""
    rng = np.random.default_rng(seed)
    srcs = rng.standard_normal((2, n * (batch - 1))) * 0.1
    rec = spatial_session(srcs, [40.0, 200.0], noise_level=0.003, seed=seed)
    wins = [rec[:, i * n:(i + 1) * n] for i in range(batch - 1)]
    wins.append(rng.standard_normal((7, n)) * 0.1)
    return np.stack(wins).astype(np.float32)


def test_epsilon_is_float32_eps():
    assert tf.EPSILON == jf.EPSILON


@pytest.mark.parametrize("dim", [-2, -1])
def test_mvn_matches(dim):
    x = np.random.default_rng(0).gamma(2.0, 1.0, (3, 50, 20)).astype(
        np.float32)
    got = tf.mvn(torch.as_tensor(x), dim=dim).numpy()
    want = np.asarray(jf.mvn(jnp.asarray(x), axis=dim))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # Bessel-corrected: unit sample std with ddof=1
    np.testing.assert_allclose(got.std(axis=dim, ddof=1), 1.0, atol=1e-4)


def test_feature_extractor_1ch_matches():
    x = (np.random.default_rng(1).standard_normal((3, 38656)) * 0.1).astype(
        np.float32)
    x[2, :20000] = 0.0  # exact silence exercises the EPSILON floor
    mag_w, feat_w, _ = jf.FeatureExtractor(512, 256)(jnp.asarray(x))
    mag, feats = tf.FeatureExtractor(512, 256)(torch.as_tensor(x))
    assert mag.shape == feats.shape == (3, 150, 257)
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_w), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(feat_w), atol=ATOL,
                               rtol=RTOL)


def test_ipd_waits_for_the_7ch_slice():
    """Named before the 7ch slice, when IPD raised; now the IPD index
    parses as in the reference, and IPD on a 1ch batch raises as there."""
    for index in ("1,0;2,0", IPD_7CH, "3,1"):
        for got, want in zip(tf.parse_ipd_index(index),
                             jf.parse_ipd_index(index)):
            np.testing.assert_array_equal(got, want)
    ext = tf.FeatureExtractor(ipd_index="1,0;2,0")
    assert ext.feature_dim == 3 * 257
    with pytest.raises(ValueError, match="multi-channel"):
        ext(torch.zeros(2, 38656))


def test_ipd_matches():
    rng = np.random.default_rng(3)
    phase = rng.uniform(-np.pi, np.pi, (2, 7, 150, 257)).astype(np.float32)
    # a pair with a constant phase difference plus small jitter: centred
    # vectors near 0, where the angle is ill-defined
    phase[:, 4] = phase[:, 0] + 0.3 + 1e-4 * rng.standard_normal(
        (2, 150, 257)).astype(np.float32)
    left, right = jf.parse_ipd_index(IPD_7CH)
    want = np.asarray(jf.ipd(jnp.asarray(phase), left, right))
    got = tf.ipd(torch.as_tensor(phase), *tf.parse_ipd_index(IPD_7CH))
    assert got.shape == want.shape == (2, 6, 150, 257)
    assert float(got.abs().max()) <= np.float32(np.pi)
    length = _centred_length(phase.astype(np.float64), left, right)
    assert (length < IPD_MIN_LENGTH).any()  # the exclusion is exercised
    keep = length >= IPD_MIN_LENGTH
    err = np.abs(_wrapped(got.numpy() - want))[keep]
    assert err.max() <= IPD_ATOL, err.max()


def test_feature_extractor_7ch_matches():
    x = _windows_7ch(4)
    mag_w, feat_w, spec_w = jf.FeatureExtractor(ipd_index=IPD_7CH)(
        jnp.asarray(x))
    mag, feats, spec = tf.FeatureExtractor(ipd_index=IPD_7CH)(
        torch.as_tensor(x), return_spec=True)
    feat_w, spec_w = np.asarray(feat_w), np.asarray(spec_w)
    assert mag.shape == (3, 150, 257) and feats.shape == (3, 150, 7 * 257)
    assert spec.shape == spec_w.shape == (3, 7, 150, 257)
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_w), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(spec.numpy(), spec_w, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(feats[..., :257].numpy(), feat_w[..., :257],
                               atol=ATOL, rtol=RTOL)
    # the IPD block, frequency-major (B, T, M*F) as in the reference
    left, right = jf.parse_ipd_index(IPD_7CH)
    length = _centred_length(np.angle(spec_w.astype(np.complex128)), left,
                             right)  # (B, M, T, F)
    length = length.transpose(0, 2, 1, 3).reshape(3, 150, 6 * 257)
    _assert_ipd_close(feats[..., 257:].numpy(), feat_w[..., 257:], length)


def test_feature_extractor_returns_the_spectrum_on_request():
    """Without IPD (the DOA merge alone needs the spectrum), on a 7ch
    batch: mag and feats are channel 0's, as in the reference."""
    x = _windows_7ch(5, batch=2)
    mag_w, feat_w, spec_w = jf.FeatureExtractor()(jnp.asarray(x))
    ext = tf.FeatureExtractor()
    mag, feats, spec = ext(torch.as_tensor(x), return_spec=True)
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_w), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(feat_w), atol=ATOL,
                               rtol=RTOL)
    mag2, feats2 = ext(torch.as_tensor(x[:, 0]))
    np.testing.assert_array_equal(mag2.numpy(), mag.numpy())
