"""The CUDA kernels on the card, against their plain versions.

These need an NVIDIA Hopper card and nvcc; elsewhere they skip. Where the
card is, JAX need not be, so run them without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Float32 with TF32 off; kernel and plain version sum the same products in
another order: 2e-4 absolute, 1e-4 relative (the tolerance of
tests/test_istft_pallas.py for the TPU kernel).
"""

import numpy as np
import pytest
import torch

from css_tpu_torch.ops import istft_cuda, stft_mag_cuda
from css_tpu_torch.ops import stft as stft_ops

pytestmark = pytest.mark.cuda
ATOL, RTOL = 2e-4, 1e-4


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
