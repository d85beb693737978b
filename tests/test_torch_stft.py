"""css_tpu_torch.ops.stft and the plain versions of K1/K3 against css_tpu.

Inputs are numpy arrays from fixed seeds, fed to both packages. The JAX
side runs on the CPU; its Pallas kernels run in interpret mode. Float32
tolerances: the two packages do the same products in another summation
order (~1e-6 relative); 2e-4 absolute is the tolerance the JAX package's
own Pallas-vs-XLA iSTFT test uses (tests/test_istft_pallas.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from css_tpu.ops import stft as jstft
from css_tpu.ops.istft_pallas import istft_pallas
from css_tpu_torch.ops import istft_cuda, stft_mag_cuda
from css_tpu_torch.ops import stft as tstft

ATOL, RTOL = 2e-4, 1e-4


def _signal(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.2
            ).astype(np.float32)


def test_constant_matrices_are_the_reference_ones():
    np.testing.assert_array_equal(tstft.hann_window(512),
                                  jstft.hann_window(512))
    np.testing.assert_array_equal(tstft.hann_window(400, periodic=False),
                                  jstft.hann_window(400, periodic=False))
    assert tstft.num_fft_bins(400) == jstft.num_fft_bins(400) == 257
    np.testing.assert_array_equal(tstft.stft_analysis_kernel(512),
                                  jstft.stft_analysis_kernel(512))
    np.testing.assert_array_equal(tstft._istft_synthesis_kernel(512, 512),
                                  jstft._istft_synthesis_kernel(512, 512))


@pytest.mark.parametrize("frame_len,hop", [(512, 256), (512, 128), (400, 160)])
def test_frame_signal_and_overlap_add(frame_len, hop):
    x = _signal((2, 4000), 0)
    np.testing.assert_array_equal(
        tstft.frame_signal(torch.as_tensor(x), frame_len, hop).numpy(),
        np.asarray(jstft.frame_signal(jnp.asarray(x), frame_len, hop)))
    frames = _signal((2, 9, frame_len), 1)
    np.testing.assert_allclose(
        tstft.overlap_add(torch.as_tensor(frames), hop, out_len=3000).numpy(),
        np.asarray(jstft.overlap_add(jnp.asarray(frames), hop, out_len=3000)),
        atol=1e-6)


@pytest.mark.parametrize("center", [False, True])
def test_stft_matches_reference(center):
    x = _signal((3, 16000), 2)
    got = tstft.stft(torch.as_tensor(x), 512, 256, center=center).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(x), 512, 256, center=center))
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("center,length", [(False, None), (False, 16100),
                                           (True, 16000), (True, None)])
def test_istft_matches_reference(center, length):
    x = _signal((2, 16000), 3)
    spec = np.asarray(jstft.stft(jnp.asarray(x), 512, 256, center=center))
    mask = np.random.default_rng(4).uniform(0, 1, spec.shape).astype(
        np.float32)
    spec = spec * mask
    got = tstft.istft(torch.as_tensor(spec), 512, 256, center=center,
                      length=length).numpy()
    want = np.asarray(jstft.istft(jnp.asarray(spec), 512, 256, center=center,
                                  length=length))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_istft_matches_pallas_kernel():
    """The plain K1 against the TPU kernel (interpret mode) on a masked
    spectrum at the beamformer's window shape."""
    x = _signal((3, 38656), 5)
    spec = np.asarray(jstft.stft(jnp.asarray(x), 512, 256, center=False))
    spec = spec * np.random.default_rng(6).uniform(0, 1, spec.shape).astype(
        np.float32)
    want = np.asarray(istft_pallas(jnp.asarray(spec), 512, 256,
                                   interpret=True))
    got = istft_cuda.istft_plain(torch.as_tensor(spec), 512, 256).numpy()
    assert got.shape == want.shape == (3, 38656)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_stft_mag_matches_pallas_kernel_and_xla():
    from css_tpu.ops._stft_pallas_r01 import stft_mag_pallas

    x = _signal((3, 38656), 7)
    pallas = np.asarray(stft_mag_pallas(jnp.asarray(x), 512, 256,
                                        interpret=True))
    xla = np.asarray(jnp.abs(jstft.stft(jnp.asarray(x), 512, 256,
                                        center=False)))
    got = stft_mag_cuda.stft_mag_plain(torch.as_tensor(x), 512, 256).numpy()
    assert got.shape == pallas.shape == (3, 150, 257)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=RTOL)


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    x = torch.as_tensor(_signal((2, 38656), 8))
    spec = tstft.stft(x, 512, 256)
    stft_mag_cuda.stft_mag.launches = 0
    istft_cuda.istft.launches = 0
    torch.testing.assert_close(stft_mag_cuda.stft_mag(x),
                               stft_mag_cuda.stft_mag_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(istft_cuda.istft(spec),
                               istft_cuda.istft_plain(spec), rtol=0, atol=0)
    assert stft_mag_cuda.stft_mag.launches == 0
    assert istft_cuda.istft.launches == 0


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    meta device stands in for a device with no kernel."""
    x = torch.empty((2, 38656), device="meta")
    spec = torch.empty((2, 150, 257), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stft_mag_cuda.stft_mag(x)
    with pytest.raises(ValueError, match="unsupported device"):
        istft_cuda.istft(spec)
