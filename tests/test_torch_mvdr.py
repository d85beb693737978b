"""css_tpu_torch.ops.mvdr, the Souden MVDR beamformer and the centered
iSTFT entry against css_tpu.

The same numpy spectra, masks and recordings go to both packages.
Float32 tolerances, each beside what was measured on the CPU:
  * SCMs, 1e-5 relative to the largest entry: sums over 152 frames in
    another order (measured ~3e-7);
  * Souden weights on SCMs that float32 determines (two broadband
    sources and 0.03 sensor noise on 7 mics, condition numbers up to
    7.7e3): 1e-4 (measured 1.7e-5);
  * beamformed streams, BF_ATOL = 1e-3 absolute on 0.9-peak streams: the
    7x7 solves amplify the SCMs' float32 rounding by the noise SCM's
    condition number (measured max 3.3e-4 over 16 such recordings);
  * the centered iSTFT, 2e-4 absolute (the tolerance of the uncentered
    plain version, tests/test_torch_stft.py).
Where the noise SCM is near-singular (a narrowband source far above the
sensor noise: condition numbers of 1e5-1e6), float32 does not determine
the weights to 1e-3 in either package: both are a few percent away from
a float64 evaluation of the same formula. There the port is held to be
no further from float64 than twice the reference is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.data.spatial import spatial_session
from css_tpu.executor import beamformer as jbf
from css_tpu.executor import windowing as jwin
from css_tpu.ops import mvdr as jmv
from css_tpu.ops import stft as jstft
from css_tpu_torch.executor import beamformer as tbf
from css_tpu_torch.ops import istft_cuda
from css_tpu_torch.ops import mvdr as tmv

BF_ATOL = 1e-3
N = 38656


def _spec(seed, windows=3, noise_level=0.003):
    """Centered spectra (B, 7, 152, 257) of windows of two white-noise
    sources at 30 and 150 degrees with sensor noise, as numpy."""
    rng = np.random.default_rng(seed)
    srcs = rng.standard_normal((2, N * windows)) * 0.1
    rec = spatial_session(srcs, [30.0, 150.0], noise_level=noise_level,
                          seed=seed)
    wins = rec.reshape(7, windows, N).transpose(1, 0, 2)
    return np.array(jstft.stft(jnp.asarray(np.ascontiguousarray(wins)), 512,
                               256, center=True))


def _masks(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_compute_scm_matches():
    spec = _spec(0)
    mask = _masks(1, spec[:, 0].shape)
    want = np.array(jmv.compute_scm(jnp.asarray(spec), jnp.asarray(mask)))
    got = tmv.compute_scm(torch.as_tensor(spec), torch.as_tensor(mask))
    assert got.shape == want.shape == (3, 257, 7, 7)
    assert got.dtype == torch.complex64
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    # Hermitian, and loaded on the diagonal
    np.testing.assert_allclose(got.numpy(), got.numpy().conj().swapaxes(-1, -2),
                               atol=1e-6 * scale)


def test_souden_coefficients_and_mvdr_match():
    """Sensor noise 0.03, 10 dB below each source, so that float32
    determines the weights (condition numbers up to 7.7e3)."""
    spec = _spec(2, noise_level=0.03)
    tgt_m = _masks(3, spec[:, 0].shape)
    noi_m = _masks(4, spec[:, 0].shape)
    tgt = np.array(jmv.compute_scm(jnp.asarray(spec), jnp.asarray(tgt_m)))
    noi = np.array(jmv.compute_scm(jnp.asarray(spec), jnp.asarray(noi_m)))
    want = np.asarray(jmv.souden_coefficients(jnp.asarray(noi),
                                              jnp.asarray(tgt)))
    got = tmv.souden_coefficients(torch.as_tensor(noi), torch.as_tensor(tgt))
    assert got.shape == want.shape == (3, 257, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    y_want = np.asarray(jmv.souden_mvdr(jnp.asarray(spec), jnp.asarray(tgt_m),
                                        jnp.asarray(noi_m)))
    y = tmv.souden_mvdr(torch.as_tensor(spec), torch.as_tensor(tgt_m),
                        torch.as_tensor(noi_m))
    assert y.shape == y_want.shape == (3, 152, 257)
    np.testing.assert_allclose(y.numpy(), y_want,
                               atol=1e-4 * np.abs(y_want).max())


def test_souden_mvdr_on_a_silent_window():
    """A window of padded silence: both SCMs are diag_loading * I =
    1e-15 * I, which float32 still solves, W = e_0 / 7, and the output is
    exactly 0 in both packages (torch.linalg.solve would raise only on an
    exactly singular matrix; the port's solve_ex never raises)."""
    spec = _spec(5, windows=2, noise_level=0.03)
    spec[1] = 0.0
    tgt_m, noi_m = _masks(6, spec[:, 0].shape), _masks(7, spec[:, 0].shape)
    want = np.asarray(jmv.souden_mvdr(jnp.asarray(spec), jnp.asarray(tgt_m),
                                      jnp.asarray(noi_m)))
    got = tmv.souden_mvdr(torch.as_tensor(spec), torch.as_tensor(tgt_m),
                          torch.as_tensor(noi_m)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(want[1], 0.0)
    np.testing.assert_allclose(got[0], want[0],
                               atol=1e-4 * np.abs(want[0]).max())
    eye = np.broadcast_to(1e-15 * np.eye(7, dtype=np.complex64),
                          (257, 7, 7))
    w = tmv.souden_coefficients(torch.as_tensor(eye.copy()),
                                torch.as_tensor(eye.copy())).numpy()
    np.testing.assert_allclose(w, np.broadcast_to(np.eye(7)[0] / 7, w.shape),
                               rtol=1e-6)
    # an exactly singular noise SCM: non-finite weights, no exception
    zero = np.zeros((257, 7, 7), np.complex64)
    w = tmv.souden_coefficients(torch.as_tensor(zero),
                                torch.as_tensor(eye.copy()))
    assert not torch.isfinite(w).all()


def test_souden_near_singular_as_accurate_as_the_reference():
    """One narrowband source 60 dB above the sensor noise: the noise SCM
    is near-singular, and float32 leaves both packages' weights a few
    percent from a float64 evaluation; the port's error is held to at
    most twice the reference's."""
    rng = np.random.default_rng(8)
    t = np.arange(N * 2) / 16000
    tone = 0.1 * np.sin(2 * np.pi * 281.25 * t)  # bin 9 exactly
    rec = spatial_session(tone[None], [90.0], noise_level=1e-4, seed=8)
    rec += 0.1 * spatial_session(rng.standard_normal((1, N * 2)), [200.0])
    wins = np.ascontiguousarray(rec.reshape(7, 2, N).transpose(1, 0, 2))
    spec = np.array(jstft.stft(jnp.asarray(wins), 512, 256, center=True))
    tgt_m, noi_m = _masks(9, spec[:, 0].shape), _masks(10, spec[:, 0].shape)
    tgt = np.array(jmv.compute_scm(jnp.asarray(spec), jnp.asarray(tgt_m)))
    noi = np.array(jmv.compute_scm(jnp.asarray(spec), jnp.asarray(noi_m)))
    assert np.linalg.cond(noi.astype(np.complex128)).max() > 1e5
    num = np.linalg.solve(noi.astype(np.complex128), tgt.astype(np.complex128))
    exact = num[..., 0] / (np.trace(num, axis1=-2, axis2=-1)[..., None]
                           + 1e-15)
    want = np.asarray(jmv.souden_coefficients(jnp.asarray(noi),
                                              jnp.asarray(tgt)))
    got = tmv.souden_coefficients(torch.as_tensor(noi),
                                  torch.as_tensor(tgt)).numpy()
    ref_err = np.abs(want - exact).max()
    assert ref_err > 1e-4  # float32 does not determine these weights
    assert np.abs(got - exact).max() <= 2 * ref_err


@pytest.mark.parametrize("t,length", [(152, 38656), (152, 40000), (5, 1000),
                                      (3, None)])
def test_centered_istft_entry_matches(t, length):
    rng = np.random.default_rng(t)
    spec = (rng.standard_normal((4, t, 257))
            + 1j * rng.standard_normal((4, t, 257))).astype(np.complex64)
    want = np.asarray(jstft.istft(jnp.asarray(spec), 512, 256, center=True,
                                  length=length))
    got = istft_cuda.istft_centered(torch.as_tensor(spec), 512, 256,
                                    length=length)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("t_mask", [150, 40, 1])
@pytest.mark.parametrize("t_spec", [150, 152, 155])
def test_align_mask_matches(t_mask, t_spec):
    """The reference's default shift of one frame, with the edges
    replicated, on masks shorter than, as long as and longer than the
    centered frames."""
    mask = _masks(11, (3, t_mask, 257))
    want = np.asarray(jbf.Beamformer()._align_mask(jnp.asarray(mask),
                                                    t_spec))
    got = tbf.Beamformer(device="cpu")._align_mask(torch.as_tensor(mask),
                                                   t_spec)
    np.testing.assert_array_equal(got.numpy(), want)


def _recording(seed, seconds):
    """Two white-noise sources at 30 and 150 degrees, 0.003 sensor noise,
    padded for the windows, (7, T)."""
    rng = np.random.default_rng(seed)
    srcs = rng.standard_normal((2, int(seconds * 16000))) * 0.1
    rec = spatial_session(srcs, [30.0, 150.0], noise_level=0.003, seed=seed)
    return jwin.pad_for_windows(rec, N, 12800), rng


@pytest.mark.parametrize("quiet", [0, 1])
@pytest.mark.parametrize("seconds", [2.0, 3.3, 8.0])
def test_beamformer_mvdr_matches(quiet, seconds):
    wav, rng = _recording(int(seconds * 10), seconds)
    n_win = (wav.shape[-1] - N) // 12800 + 1
    t_total = (n_win - 1) * 50 + 150
    masks = [rng.uniform(0, 1, (t_total, 257)).astype(np.float32)
             for _ in range(3)]
    masks[quiet][:, :100] *= 1e-3  # one quiet stream exercises the dedup
    want = jbf.Beamformer("SoudenMVDRBeamformer").continuous_process(wav,
                                                                     masks)
    bf = tbf.Beamformer("SoudenMVDRBeamformer", device="cpu")
    assert bf.bf_type == "souden_mvdr"
    got = bf.continuous_process(torch.as_tensor(wav),
                                [torch.as_tensor(m) for m in masks])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (wav.shape[-1],)
        np.testing.assert_allclose(g.numpy(), w, atol=BF_ATOL)
        assert abs(float(g.abs().max()) - 0.9) < 1e-5


def test_beamformer_mvdr_on_one_channel_is_an_energy_rescale():
    """D = 1 (a (T,) recording): the reference's Souden MVDR reduces to
    the mixture rescaled to the masked energy; the port gives the same."""
    rng = np.random.default_rng(12)
    wav = jwin.pad_for_windows(
        (rng.standard_normal(40000) * 0.1).astype(np.float32), N, 12800)
    n_win = (len(wav) - N) // 12800 + 1
    masks = [rng.uniform(0, 1, ((n_win - 1) * 50 + 150, 257)).astype(
        np.float32) for _ in range(3)]
    want = jbf.Beamformer().continuous_process(wav, masks)
    got = tbf.Beamformer(device="cpu").continuous_process(
        torch.as_tensor(wav), [torch.as_tensor(m) for m in masks])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=BF_ATOL)
