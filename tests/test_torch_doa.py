"""css_tpu_torch.executor.doa against css_tpu.executor.doa.

The same numpy spectra and masks go to both. doa_likelihood is compared
numerically: float32 sums over 150 frames x 62 bins of compressed
residual powers, of order 1e3-1e4 here, 1e-4 relative and LIK_ATOL
absolute. The residual xpow - |sv^H x|^2 cancels at a source's own angle,
and its square root magnifies the rounding there: on these inputs the
reference itself is up to 6.8e-3 away from a float64 evaluation of the
same sums (the port 3.0e-3, measured on the CPU), hence LIK_ATOL = 1e-2.
angle_merge is compared only on windows whose decision is
clear, since an argmax over 30 angles followed by a threshold can flip
between packages on a near-tie: two sources 120 degrees apart (keep both)
and one source under both masks (kill the weaker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.data.spatial import spatial_session
from css_tpu.executor import doa as jdoa
from css_tpu.ops import stft as jstft
from css_tpu_torch.executor import doa as tdoa

N = 38656
LIK_ATOL = 1e-2


def test_steering_vectors_match():
    sv, ang = tdoa.steervec_7ch()
    sv_w, ang_w = jdoa.steervec_7ch()
    np.testing.assert_array_equal(sv, sv_w)
    np.testing.assert_array_equal(ang, ang_w)
    t, j = tdoa.SteeringVectors(), jdoa.SteeringVectors()
    assert (t.lo, t.hi) == (j.lo, j.hi) == (2, 64)


def _spec(rec):
    """(B, 7, n) windows -> their uncentered (B, 7, 150, 257) spectra,
    from the reference's STFT, as numpy."""
    return np.array(jstft.stft(jnp.asarray(rec), 512, 256, center=False))


def _two_sources(seed, azimuths):
    """Two white-noise sources at ``azimuths`` on the 7-mic array, one
    window each of the two alone, (2, 7, N) each, with 0.003 sensor noise."""
    rng = np.random.default_rng(seed)
    srcs = rng.standard_normal((2, N)) * 0.1
    return [spatial_session(s[None], [az], noise_level=0.003, seed=seed + i)
            for i, (s, az) in enumerate(zip(srcs, azimuths))]


def test_doa_likelihood_matches():
    rng = np.random.default_rng(1)
    a, b = _two_sources(1, [30.0, 150.0])
    spec = _spec(np.stack([a + b, a, b]).astype(np.float32))
    mask = rng.uniform(0.0, 1.0, spec[:, 0].shape + (2,)).astype(np.float32)
    sv = tdoa.SteeringVectors()
    for compression in (0.5, 1.0):
        want = np.asarray(jdoa.SteeringVectors().doa_likelihood(
            jnp.asarray(spec), jnp.asarray(mask), compression=compression))
        got = sv.doa_likelihood(torch.as_tensor(spec), torch.as_tensor(mask),
                                compression=compression)
        assert got.shape == want.shape == (3, 2, 30)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=LIK_ATOL)


def _merge_both(spec, mask):
    want = np.asarray(jdoa.SteeringVectors().angle_merge(
        jnp.asarray(spec), jnp.asarray(mask)))
    sv = tdoa.SteeringVectors()
    got = sv.angle_merge(torch.as_tensor(spec), torch.as_tensor(mask))
    kill, doa = sv.merge_decisions(torch.as_tensor(spec),
                                   torch.as_tensor(mask))
    return got.numpy(), want, kill.numpy(), doa.numpy()


@pytest.mark.parametrize("azimuths", [(30.0, 150.0), (0.0, 240.0)])
def test_angle_merge_keeps_two_sources_apart(azimuths):
    a, b = _two_sources(2, azimuths)
    mix = (a + b).astype(np.float32)
    spec = _spec(mix[None])
    sa, sb = np.abs(_spec(a[None].astype(np.float32))[:, 0]), np.abs(
        _spec(b[None].astype(np.float32))[:, 0])
    mask = np.stack([sa > sb, sb >= sa], axis=-1).astype(np.float32)
    got, want, kill, doa = _merge_both(spec, mask)
    assert not kill.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mask)
    # each stream's DOA is its source's, to the 12-degree grid
    for d, az in zip(doa[0], azimuths):
        assert min(abs(d - az), 360 - abs(d - az)) <= 12.0


@pytest.mark.parametrize("weaker", [0, 1])
def test_angle_merge_kills_the_weaker_of_one_source(weaker):
    """Both masks on the same source: the stream with less masked
    magnitude is killed (its mask set to 1e-12), the other kept."""
    a, _ = _two_sources(3, [90.0, 0.0])
    spec = _spec(a[None].astype(np.float32))
    mag = np.abs(spec[:, 0])
    strong = (mag > np.median(mag)).astype(np.float32)
    weak = (mag > np.quantile(mag, 0.9)).astype(np.float32)
    mask = np.stack([weak, strong] if weaker == 0 else [strong, weak],
                    axis=-1) * 0.9
    got, want, kill, _ = _merge_both(spec, mask)
    np.testing.assert_array_equal(kill[0], np.arange(2) == weaker)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., weaker],
                                  np.full_like(got[..., weaker], 1e-12))
    np.testing.assert_array_equal(got[..., 1 - weaker], mask[..., 1 - weaker])


def test_kill_masks():
    mask = np.random.default_rng(4).uniform(size=(3, 5, 7, 2)).astype(
        np.float32)
    kill = torch.tensor([[False, False], [True, False], [False, True]])
    got = tdoa.kill_masks(torch.as_tensor(mask), kill).numpy()
    np.testing.assert_array_equal(got[0], mask[0])
    assert (got[1, ..., 0] == np.float32(1e-12)).all()
    np.testing.assert_array_equal(got[1, ..., 1], mask[1, ..., 1])
    assert (got[2, ..., 1] == np.float32(1e-12)).all()
