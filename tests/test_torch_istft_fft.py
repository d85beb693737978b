"""K1's FFT design rehearsed on the CPU, where no card is.

``kernel_model`` follows ``css_tpu_torch/csrc/istft.cu`` step by step in
numpy float32, on the very tables the wrapper passes to the kernel
(``istft_cuda._tables``): Im X[0] and Im X[M] zeroed, the inverse split,
the bit-reversed store, the radix-2 inverse FFT with the conjugated stage
twiddles, the unpack, the window, the overlap-add of a head and a tail per
hop-slot with the 1/N scale and the (3, hop) envelope table. It is held
against the port's plain version and against the JAX package's Pallas
kernel (interpret mode) on the same numpy inputs, at the tolerance of
tests/test_istft_pallas.py (2e-4 absolute, 1e-4 relative). The route
predicate and the envelope table, which decide from the shape alone, are
checked too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from css_tpu.ops.istft_pallas import _envelope_recip, istft_pallas
from css_tpu_torch.ops import istft_cuda, stft_mag_cuda
from css_tpu_torch.ops import stft as stft_ops

ATOL, RTOL = 2e-4, 1e-4
CPU = torch.device("cpu")


def kernel_model(spec: np.ndarray, frame_len: int, hop: int,
                 zero_edges: bool = True) -> np.ndarray:
    """csrc/istft.cu's arithmetic on complex (rows, T, bins)."""
    rows, t, bins = spec.shape
    n_fft = 2 * (bins - 1)
    m = n_fft // 2
    log_m = m.bit_length() - 1
    twid, window, env = (a.numpy() for a in istft_cuda._tables(
        frame_len, hop, n_fft, CPU))
    tw = (twid[:, 0] + 1j * twid[:, 1]).astype(np.complex64)
    x = spec.astype(np.complex64)
    if zero_edges:
        x = x.copy()
        x[..., 0] = x[..., 0].real
        x[..., m] = x[..., m].real
    k = np.arange(m)
    a, c = x[..., k], np.conj(x[..., m - k])
    z_nat = (a + c) + 1j * (np.conj(tw[:m]) * (a - c))
    rev = np.array([int(format(i, f"0{log_m}b")[::-1], 2) for i in k])
    z = np.empty_like(z_nat)
    z[..., rev] = z_nat
    b = np.arange(m // 2)
    for s in range(log_m):
        half = 1 << s
        stage = np.conj(tw[m + half - 1: m + 2 * half - 1])
        pos = b & (half - 1)
        i0 = ((b >> s) << (s + 1)) + pos
        i1 = i0 + half
        u, v = z[..., i0], z[..., i1] * stage[pos]
        z[..., i0], z[..., i1] = u + v, u - v
    frames = np.empty((rows, t, n_fft), np.float32)
    frames[..., 0::2], frames[..., 1::2] = z.real, z.imag
    frames = frames[..., :frame_len] * window
    slots = np.zeros((rows, t + 1, hop), np.float32)
    slots[:, :t] += frames[..., :hop]
    slots[:, 1:] += frames[..., hop:]
    kind = np.ones(t + 1, int)
    kind[0], kind[t] = 0, 2
    slots *= np.float32(1.0 / n_fft) * env[kind]
    return slots.reshape(rows, (t + 1) * hop)


def _spectrum(rows, t, bins, seed):
    """Random complex spectrum with an imaginary part in every bin, DC and
    Nyquist included."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, t, bins))
            + 1j * rng.standard_normal((rows, t, bins))).astype(np.complex64)


@pytest.mark.parametrize("frame_len,hop,t", [(512, 256, 9), (512, 256, 1),
                                             (400, 200, 6), (400, 200, 1)])
def test_kernel_model_matches_plain_and_pallas(frame_len, hop, t):
    spec = _spectrum(3, t, 257, frame_len + t)
    got = kernel_model(spec, frame_len, hop)
    plain = istft_cuda.istft_plain(torch.as_tensor(spec), frame_len,
                                   hop).numpy()
    pallas = np.asarray(istft_pallas(jnp.asarray(spec), frame_len, hop,
                                     interpret=True))
    assert got.shape == plain.shape == pallas.shape == (3, (t + 1) * hop)
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_kernel_model_needs_the_zeroed_edge_bins():
    """Without zeroing Im X[0] and Im X[M] the split disagrees with the
    reference on a spectrum whose DC and Nyquist bins have an imaginary
    part: the test above would catch a kernel that skipped it."""
    spec = _spectrum(2, 5, 257, 7)
    plain = istft_cuda.istft_plain(torch.as_tensor(spec)).numpy()
    wrong = kernel_model(spec, 512, 256, zero_edges=False)
    assert np.abs(wrong - plain).max() > 100 * ATOL
    spec[..., [0, 256]] = spec[..., [0, 256]].real
    np.testing.assert_allclose(kernel_model(spec, 512, 256, zero_edges=False),
                               plain, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("frame_len,hop,n_fft,kernel", [
    (512, 256, 512, True), (400, 200, 512, True), (4, 2, 4, True),
    (2048, 1024, 2048, True), (256, 128, 512, True), (512, 128, 512, False),
    (4096, 2048, 4096, False), (2, 1, 2, False), (400, 200, 400, False),
    (512, 256, 256, False)])
def test_istft_route(frame_len, hop, n_fft, kernel):
    """frame_len == 2*hop <= n_fft, n_fft a power of two in [4, 2048]."""
    assert istft_cuda.takes_kernel(frame_len, hop, n_fft) is kernel


@pytest.mark.parametrize("frame_len,t", [(512, 1), (512, 2), (512, 7),
                                         (400, 5), (4, 3)])
def test_istft_envelope_table(frame_len, t):
    """The (3, hop) table laid out over slots 0, 1..T-1, T is the JAX
    package's full-length envelope reciprocal, to the bit; the twiddles are
    K3's table itself."""
    hop = frame_len // 2
    n_fft = 2 * (stft_ops.num_fft_bins(frame_len) - 1)
    twid, window, env = istft_cuda._tables(frame_len, hop, n_fft, CPU)
    assert env.shape == (3, hop) and env.dtype == torch.float32
    kind = [0] + [1] * (t - 1) + [2]
    full = env.numpy()[kind].reshape(-1)
    np.testing.assert_array_equal(full, _envelope_recip(frame_len, hop, t))
    assert twid is stft_mag_cuda.twiddles(n_fft, CPU)
    np.testing.assert_array_equal(
        window.numpy(), stft_ops.hann_window(frame_len))
