"""The CUDA kernels on the card, against their plain versions.

These need an NVIDIA Hopper card and nvcc; elsewhere they skip. Where the
card is, JAX need not be, so run them without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Float32 with TF32 off; kernel and plain version sum the same products in
another order: 2e-4 absolute, 1e-4 relative (the tolerance of
tests/test_istft_pallas.py for the TPU kernel). K2 in bfloat16: h is
rounded to bf16 every step in both, so a value near a rounding boundary
can land one bf16 step (up to 2^-8 on |h| < 1) the other way and carry
into later steps: 3e-2 absolute (about 8 such steps).
"""

import numpy as np
import pytest
import torch

from css_tpu_torch.ops import istft_cuda, lstm_cuda, stft_mag_cuda
from css_tpu_torch.ops import stft as stft_ops

pytestmark = pytest.mark.cuda
ATOL, RTOL = 2e-4, 1e-4
LSTM_BF16_ATOL = 3e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py`")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _signal(shape, seed, dev):
    x = np.random.default_rng(seed).standard_normal(shape) * 0.1
    return torch.as_tensor(x.astype(np.float32), device=dev)


@pytest.mark.parametrize("rows,n", [(1, 512), (3, 5000), (32, 38656)])
def test_stft_mag_kernel_matches_plain(card, rows, n):
    x = _signal((rows, n), rows, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 1
    want = stft_mag_cuda.stft_mag_plain(x)
    assert got.shape == want.shape == (rows, (n - 512) // 256 + 1, 257)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows,n", [(1, 512), (5, 5120), (146, 38656)])
def test_istft_kernel_matches_plain(card, rows, n):
    spec = stft_ops.stft(_signal((rows, n), rows, card))
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = istft_cuda.istft_plain(spec)
    assert got.shape == want.shape == (rows, (spec.shape[1] + 1) * 256)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_kernels_refuse_what_they_do_not_take(card):
    x = _signal((4, 6000), 0, card)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mag_cuda.stft_mag(x[:, ::2])
    with pytest.raises(TypeError):
        stft_mag_cuda.stft_mag(x.double())
    with pytest.raises(ValueError, match="2\\*hop"):
        stft_mag_cuda.stft_mag(x, 512, 128)
    spec = stft_ops.stft(x)
    with pytest.raises(ValueError, match="contiguous"):
        istft_cuda.istft(spec.transpose(0, 1))
    with pytest.raises(TypeError):
        istft_cuda.istft(spec.to(torch.complex128))
    with pytest.raises(ValueError, match="2\\*hop"):
        istft_cuda.istft(spec, 512, 128)


def _lstm_inputs(b, t, h, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    # recurrent weights of order 1/sqrt(h) (the BLSTM's orthogonal W_hh:
    # 1/sqrt(4h)), so the recurrence neither vanishes nor saturates
    w_hh = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return (torch.as_tensor(xw, device=dev).to(dtype),
            torch.as_tensor(w_hh, device=dev).to(dtype))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h", [(32, 150, 512), (32, 150, 1024),
                                   (5, 37, 128), (3, 4, 99)])
def test_lstm_kernel_matches_plain(card, b, t, h, dtype, reverse):
    xw, w_hh = _lstm_inputs(b, t, h, dtype, b + h, card)
    before = lstm_cuda.lstm_fused.launches
    got = lstm_cuda.lstm_fused(xw, w_hh, h, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fused.launches == before + 1
    want = lstm_cuda.lstm_plain(xw, w_hh, h, reverse=reverse)
    assert got.shape == want.shape == (b, t, h) and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=LSTM_BF16_ATOL, rtol=0)


def test_lstm_kernel_refuses_what_it_does_not_take(card):
    xw, w_hh = _lstm_inputs(4, 6, 64, torch.float32, 0, card)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_fused(xw.transpose(0, 1), w_hh, 64)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fused(xw.half(), w_hh.half(), 64)
    with pytest.raises(ValueError, match="4h"):
        lstm_cuda.lstm_fused(xw, w_hh, 32)
    with pytest.raises(ValueError, match="does not fit"):
        big, w_big = _lstm_inputs(129, 2, 1024, torch.float32, 0, card)
        lstm_cuda.lstm_fused(big, w_big, 1024)
