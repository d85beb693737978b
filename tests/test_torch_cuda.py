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
into later steps: 3e-2 absolute (about 8 such steps). K2 in float32 is
held also to 5e-6 absolute (chip_smoke.py's LSTM_F32_MAX_ERR): its 3xTF32
product keeps ~21 of float32's 24 bits, and a single-TF32 product of the
same function fails that bound (test_lstm_f32_bound_catches_single_tf32).
The conv module's kernel (KC) keeps float32 inside and rounds once: in
float32 it differs from the plain chain by summation order, 2e-5 absolute
and 1e-5 relative; in bf16 it lies within one rounding (2^-8 relative)
of the float32 chain, and no farther from the plain bf16 chain than that
chain's own rounding error plus one rounding. The residual add and
LayerNorm kernel (KN) forms the sum as ``x + 0.5 * y`` does (bit-equal) and
normalises it in float32 in another order than PyTorch's LayerNorm: 1e-5
absolute and relative in float32; in bf16 both round nearly the same
float32 value, so one bf16 step apart at most (2^-7 relative).
"""

import numpy as np
import pytest
import torch

from css_tpu_torch.ops import add_layer_norm_cuda as aln
from css_tpu_torch.ops import conv_module_cuda as ccm
from css_tpu_torch.ops import istft_cuda, lstm_cuda, stft_mag_cuda
from css_tpu_torch.ops import stft as stft_ops

pytestmark = pytest.mark.cuda
ATOL, RTOL = 2e-4, 1e-4
LSTM_BF16_ATOL = 3e-2
LSTM_F32_MAX_ERR = 5e-6
KN_ATOL = KN_RTOL = 1e-5
KN_BF16_ATOL, KN_BF16_RTOL = 1e-4, 2.0 ** -7


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


@pytest.mark.parametrize("rows,n", [(1, 512), (3, 5000), (7, 2816),
                                    (32, 38400), (32, 38656)])
def test_stft_mag_kernel_matches_plain(card, rows, n):
    x = _signal((rows, n), rows, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 1
    want = stft_mag_cuda.stft_mag_plain(x)
    assert got.shape == want.shape == (rows, (n - 512) // 256 + 1, 257)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("frame,hop", [(4, 2), (64, 32), (400, 200),
                                       (1024, 512), (2048, 1024)])
def test_stft_mag_kernel_other_framings(card, frame, hop):
    """Every FFT length the kernel takes, and a frame shorter than its FFT
    (400 in 512: the frame is zero-padded)."""
    x = _signal((3, 9 * hop + frame), frame, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x, frame, hop)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 1
    want = stft_mag_cuda.stft_mag_plain(x, frame, hop)
    assert got.shape == want.shape == (3, 10, stft_ops.num_fft_bins(frame))
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


@pytest.mark.parametrize("frame,hop", [(4, 2), (64, 32), (400, 200),
                                       (1024, 512), (2048, 1024)])
def test_istft_kernel_other_framings(card, frame, hop):
    """Every FFT length the kernel takes, and a frame shorter than its FFT
    (400 in 512: the irfft is cut to the frame)."""
    spec = stft_ops.stft(_signal((3, 9 * hop + frame), frame, card), frame,
                         hop)
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec, frame, hop)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = istft_cuda.istft_plain(spec, frame, hop)
    assert got.shape == want.shape == (3, 11 * hop)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows,frames", [(5, 19), (4, 1)])
def test_istft_kernel_random_spectrum(card, rows, frames):
    """A random complex spectrum with imaginary parts in the DC and Nyquist
    bins, which the irfft ignores and the split step must too; and T = 1,
    a recording of one frame (slot 0 and slot T only)."""
    rng = np.random.default_rng(rows)
    spec = (rng.standard_normal((rows, frames, 257))
            + 1j * rng.standard_normal((rows, frames, 257))) * 0.1
    spec = torch.as_tensor(spec.astype(np.complex64), device=card)
    assert float(spec[..., [0, 256]].imag.abs().min()) > 0
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = istft_cuda.istft_plain(spec)
    assert got.shape == want.shape == (rows, (frames + 1) * 256)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows,n,length", [(146, 38656, 38656),
                                           (4, 5120, 5000),
                                           (3, 2816, 4000)])
def test_istft_centered_entry_matches_plain(card, rows, n, length):
    """K1 through its centered entry (the Souden MVDR path's synthesis):
    one launch, then the centering trim and the cut or pad to length."""
    spec = stft_ops.stft(_signal((rows, n), rows + 1, card), center=True)
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft_centered(spec, 512, 256, length)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = stft_ops.istft(spec, 512, 256, center=True, length=length)
    assert got.shape == want.shape == (rows, length)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _recording_7ch(seconds, seed):
    """Two noise sources at 30 and 150 degrees on the 7-mic array with
    0.03 sensor noise, so that float32 determines the Souden weights
    (tests/test_torch_mvdr.py)."""
    from css_tpu_torch.data.spatial import spatialize

    rng = np.random.default_rng(seed)
    srcs = rng.standard_normal((2, int(seconds * 16000))) * 0.1
    return spatialize(srcs, [30.0, 150.0], noise_level=0.03, rng=rng), rng


def test_mvdr_on_the_card_matches_the_cpu(card):
    """ops.mvdr on the card (batched complex einsums and
    torch.linalg.solve_ex) against the same on the CPU: the SCMs to 1e-5
    of their largest entry, the beamformed spectrum to 1e-4 of its."""
    from css_tpu_torch.ops import mvdr

    rec, rng = _recording_7ch(38656 * 3 / 16000, 1)
    wins = torch.as_tensor(np.ascontiguousarray(
        rec.reshape(7, 3, 38656).transpose(1, 0, 2)))
    spec = stft_ops.stft(wins, center=True)  # (3, 7, 152, 257)
    tgt_m, noi_m = (torch.as_tensor(rng.uniform(0, 1, (3, 152, 257))
                                    .astype(np.float32)) for _ in range(2))
    scm = mvdr.compute_scm(spec.to(card), tgt_m.to(card)).cpu()
    want = mvdr.compute_scm(spec, tgt_m)
    assert float((scm - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got = mvdr.souden_mvdr(spec.to(card), tgt_m.to(card), noi_m.to(card))
    want = mvdr.souden_mvdr(spec, tgt_m, noi_m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.parametrize("seconds", [3.3, 8.0])
def test_mvdr_beamformer_on_the_card_matches_the_cpu(card, seconds):
    """The Souden MVDR beamformer on a (7, T) recording, on the card (K1
    through the centered entry, one launch) and on the CPU (the plain
    versions): the 0.9-peak streams to 1e-3 (tests/test_torch_mvdr.py)."""
    from css_tpu_torch.executor.beamformer import Beamformer
    from css_tpu_torch.executor.windowing import pad_for_windows

    rec, rng = _recording_7ch(seconds, 2)
    wav = pad_for_windows(torch.as_tensor(rec), 38656, 12800)
    n_win = (wav.shape[-1] - 38656) // 12800 + 1
    masks = [torch.as_tensor(rng.uniform(0, 1, ((n_win - 1) * 50 + 150, 257))
                             .astype(np.float32)) for _ in range(3)]
    want = Beamformer(device="cpu").continuous_process(wav, masks)
    before = istft_cuda.istft.launches
    got = Beamformer(device=card).continuous_process(
        wav.to(card), [m.to(card) for m in masks])
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=0.0)


def test_kernels_refuse_what_they_do_not_take(card):
    """Wrong layouts and types raise; a framing other than frame_len ==
    2*hop takes the plain route, counted, with no launch."""
    x = _signal((4, 6000), 0, card)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mag_cuda.stft_mag(x[:, ::2])
    with pytest.raises(TypeError):
        stft_mag_cuda.stft_mag(x.double())
    launches, routes = (stft_mag_cuda.stft_mag.launches,
                        stft_mag_cuda.stft_mag.plain_routes)
    got = stft_mag_cuda.stft_mag(x, 512, 128)
    assert stft_mag_cuda.stft_mag.launches == launches
    assert stft_mag_cuda.stft_mag.plain_routes == routes + 1
    torch.testing.assert_close(got, stft_mag_cuda.stft_mag_plain(x, 512, 128),
                               atol=0, rtol=0)
    spec = stft_ops.stft(x)
    with pytest.raises(ValueError, match="contiguous"):
        istft_cuda.istft(spec.transpose(0, 1))
    with pytest.raises(TypeError):
        istft_cuda.istft(spec.to(torch.complex128))
    launches, routes = istft_cuda.istft.launches, istft_cuda.istft.plain_routes
    got = istft_cuda.istft(spec, 512, 128)
    assert istft_cuda.istft.launches == launches
    assert istft_cuda.istft.plain_routes == routes + 1
    torch.testing.assert_close(got, istft_cuda.istft_plain(spec, 512, 128),
                               atol=0, rtol=0)


def test_kernels_split_rows_beyond_one_launch(card):
    """70000 rows, more than gridDim.y takes: two launches, exact."""
    rows = 70000
    x = _signal((rows, 768), 1, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 2
    torch.testing.assert_close(got, stft_mag_cuda.stft_mag_plain(x),
                               atol=ATOL, rtol=RTOL)
    spec = stft_ops.stft(x)
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 2
    assert got.shape == (rows, 3 * 256)
    torch.testing.assert_close(got, istft_cuda.istft_plain(spec),
                               atol=ATOL, rtol=RTOL)


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
        assert float((got - want).abs().max()) <= LSTM_F32_MAX_ERR
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=LSTM_BF16_ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,n_launch", [(300, 20, 512, 10),
                                            (300, 12, 1024, 10)])
def test_lstm_kernel_splits_the_batch(card, b, t, h, n_launch, dtype,
                                      reverse):
    """A batch beyond one launch's limit (32 rows: two 16-row mma tiles)
    is split across launches, exactly."""
    xw, w_hh = _lstm_inputs(b, t, h, dtype, b + h, card)
    before = lstm_cuda.lstm_fused.launches
    got = lstm_cuda.lstm_fused(xw, w_hh, h, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fused.launches == before + n_launch
    want = lstm_cuda.lstm_plain(xw, w_hh, h, reverse=reverse)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        assert float((got - want).abs().max()) <= LSTM_F32_MAX_ERR
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=LSTM_BF16_ATOL, rtol=0)


def _carry(b, h, dtype, seed, dev):
    """A stream's carried (h0 in dtype, c0 float32), h0 in (-1, 1)."""
    rng = np.random.default_rng(seed)
    h0 = np.tanh(rng.standard_normal((b, h))).astype(np.float32)
    c0 = rng.standard_normal((b, h)).astype(np.float32)
    return (torch.as_tensor(h0, device=dev).to(dtype),
            torch.as_tensor(c0, device=dev))


def _lstm_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        assert float((got - want).abs().max()) <= LSTM_F32_MAX_ERR
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=LSTM_BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,n_launch", [(1, 8, 1024, 1),
                                            (5, 37, 128, 1),
                                            (40, 9, 512, 2)])
def test_lstm_kernel_carried_state_matches_plain(card, b, t, h, n_launch,
                                                 dtype):
    """A carried (h0, c0) in and the final (h, c) out (streaming's chunk
    shape (1, 8, 4096) at hidden 1024 first): kernel against the plain
    version, the batch split across launches with each part's rows of h0
    and c0."""
    xw, w_hh = _lstm_inputs(b, t, h, dtype, b + h + 1, card)
    state = _carry(b, h, dtype, b + h + 2, card)
    before = lstm_cuda.lstm_fused.launches
    got, (h_t, c_t) = lstm_cuda.lstm_fused(xw, w_hh, h, state=state,
                                           return_state=True)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fused.launches == before + n_launch
    want, (wh, wc) = lstm_cuda.lstm_plain(xw, w_hh, h, state=state,
                                          return_state=True)
    assert c_t.dtype == torch.float32 and h_t.dtype == dtype
    _lstm_close(got, want, dtype)
    _lstm_close(h_t, wh, dtype)
    torch.testing.assert_close(c_t, wc, atol=LSTM_BF16_ATOL
                               if dtype == torch.bfloat16 else ATOL,
                               rtol=0 if dtype == torch.bfloat16 else RTOL)
    # the state changes the result (step 0 ran its product)
    assert float((got.float() - lstm_cuda.lstm_fused(
        xw, w_hh, h).float()).abs().max()) > 1e-2


@pytest.mark.parametrize("h", [512, 1024])
def test_lstm_kernel_chained_chunks_equal_one_launch(card, h):
    """Launches chained over 8-frame chunks through the returned state
    equal one launch over the whole sequence (float32 carry; expected bit
    for bit, held to the tight float32 bound)."""
    xw, w_hh = _lstm_inputs(1, 40, h, torch.float32, h + 5, card)
    whole, (h_w, c_w) = lstm_cuda.lstm_fused(xw, w_hh, h, return_state=True)
    state, parts = None, []
    for lo in range(0, 40, 8):
        hs, state = lstm_cuda.lstm_fused(xw[:, lo:lo + 8].contiguous(), w_hh,
                                         h, state=state, return_state=True)
        parts.append(hs)
    got = torch.cat(parts, dim=1)
    assert float((got - whole).abs().max()) <= LSTM_F32_MAX_ERR
    assert float((state[1] - c_w).abs().max()) <= LSTM_F32_MAX_ERR
    with pytest.raises(ValueError, match="reverse"):
        lstm_cuda.lstm_fused(xw, w_hh, h, reverse=True, state=state)


@pytest.mark.parametrize("h", [512, 1024])
def test_lstm_f32_bound_catches_single_tf32(card, h):
    """The control for the tight float32 bound: the plain version with its
    product in single TF32 (torch's TF32 matmul) misses it."""
    xw, w_hh = _lstm_inputs(32, 150, h, torch.float32, 32 + h, card)
    want = lstm_cuda.lstm_plain(xw, w_hh, h)
    torch.backends.cuda.matmul.allow_tf32 = True
    ctrl = lstm_cuda.lstm_plain(xw, w_hh, h)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert float((ctrl - want).abs().max()) > LSTM_F32_MAX_ERR


def test_lstm_kernel_refuses_a_grid_that_cannot_all_be_resident(
        card, monkeypatch):
    """A plan with more clusters than the card holds at once raises and
    names the shape; it never falls back to the plain version. 128 blocks
    at hidden 1024 in float32 (8 units, one block per SM) are 16 clusters
    of 8, one more than the H100 holds."""
    monkeypatch.setattr(lstm_cuda, "MAX_BLOCKS", 128)
    assert lstm_cuda.lstm_plan(1024, 4).blocks == 128
    xw, w_hh = _lstm_inputs(4, 3, 1024, torch.float32, 0, card)
    launches, routes = (lstm_cuda.lstm_fused.launches,
                        lstm_cuda.lstm_fused.plain_routes)
    with pytest.raises(ValueError, match=r"\(4, 3, 4096\).*resident"):
        lstm_cuda.lstm_fused(xw, w_hh, 1024)
    assert lstm_cuda.lstm_fused.launches == launches
    assert lstm_cuda.lstm_fused.plain_routes == routes


def test_lstm_phase_split(card):
    """The optional clock64() phase record: positive cycles per step in
    each phase, and the launch's result unchanged."""
    xw, w_hh = _lstm_inputs(32, 20, 512, torch.float32, 3, card)
    split = lstm_cuda.phase_split(xw, w_hh, 512)
    assert set(split) == {"wait", "stage", "product", "gates"}
    assert all(v > 0 for v in split.values())


def test_lstm_kernel_refuses_what_it_does_not_take(card):
    """Wrong layouts and types raise; batch 129 at hidden 1024 is split
    into five launches; a hidden size whose W_hh slice does not fit in
    shared memory takes the plain route, counted, with no launch."""
    xw, w_hh = _lstm_inputs(4, 6, 64, torch.float32, 0, card)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_fused(xw.transpose(0, 1), w_hh, 64)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fused(xw.half(), w_hh.half(), 64)
    with pytest.raises(ValueError, match="4h"):
        lstm_cuda.lstm_fused(xw, w_hh, 32)
    big, w_big = _lstm_inputs(129, 2, 1024, torch.float32, 0, card)
    before = lstm_cuda.lstm_fused.launches
    got = lstm_cuda.lstm_fused(big, w_big, 1024)
    assert lstm_cuda.lstm_fused.launches == before + 5
    torch.testing.assert_close(got, lstm_cuda.lstm_plain(big, w_big, 1024),
                               atol=ATOL, rtol=RTOL)
    wide, w_wide = _lstm_inputs(2, 3, 1536, torch.float32, 0, card)
    launches, routes = (lstm_cuda.lstm_fused.launches,
                        lstm_cuda.lstm_fused.plain_routes)
    got = lstm_cuda.lstm_fused(wide, w_wide, 1536)
    assert lstm_cuda.lstm_fused.launches == launches
    assert lstm_cuda.lstm_fused.plain_routes == routes + 1
    torch.testing.assert_close(got, lstm_cuda.lstm_plain(wide, w_wide, 1536),
                               atol=0, rtol=0)


# the training path's K3 shapes: one launch over the row-stacked mix and
# two sources of a batch of 32 (96 rows), at every window bucket of the
# recipe (2.0-4.0 s by 0.5) and the two of --align-window-frames 128
@pytest.mark.parametrize("n", [32000, 40000, 48000, 56000, 64000, 33024,
                               65792])
def test_stft_mag_kernel_at_the_training_buckets(card, n):
    x = _signal((96, n), n, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 1
    want = stft_mag_cuda.stft_mag_plain(x)
    assert got.shape == want.shape == (96, (n - 512) // 256 + 1, 257)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_relative_position_gradient_is_deterministic(card):
    """The Conformer's relative-position gather differentiates into pe_k
    by index_put_(accumulate=True); on the card two backward passes at the
    longest training window give bit-equal gradients."""
    from css_tpu_torch.models.conformer import ConformerEncoder

    enc = ConformerEncoder(num_blocks=1).to(card)
    torch.nn.init.normal_(enc.pe_k)
    g = torch.Generator(card).manual_seed(0)
    upstream = torch.randn((249, 249, 64), generator=g, device=card)
    grads = []
    for _ in range(2):
        enc.pe_k.grad = None
        (enc.rel_pos(249) * upstream).sum().backward()
        grads.append(enc.pe_k.grad.clone())
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().sum() > 0


def _parallel_spec(tmp_path, world, strategy="dp"):
    """A small Conformer's DP steps through css_tpu_torch.parallel.runner,
    its ranks sharing the card over gloo."""
    from css_tpu_torch.models import build_model, init_variables
    from css_tpu_torch.parallel import runner
    from css_tpu_torch.trainer.checkpoint import save_checkpoint_dict

    # one speaker: permutation-invariant training over two near-equal
    # random-init outputs can pick the other order for an example on a
    # rounding difference, which moves its gradient by a finite step
    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0,
            "num_spk": 1}
    params, stats = init_variables(build_model("Conformer", conf), 3)
    save_checkpoint_dict(str(tmp_path / "init.mdl"),
                         {"params": params, "batch_stats": stats})
    rng = np.random.default_rng(4)
    runner.save_batches(tmp_path / "b.npz", [
        {k: (rng.standard_normal((8, 32000)) * 0.1).astype(np.float32)
         for k in ("mix", "source1")} for _ in range(2)])
    return {"strategy": strategy, "world": world, "device": "cuda",
            "model": {"name": "Conformer", "conf": conf},
            "objective": {"name": "MSE"},
            "trainer": {"optim": "sgd", "lr": 1e-3, "grad_thresh": 5.0},
            "init": str(tmp_path / "init.mdl"),
            "batches": str(tmp_path / "b.npz"), "steps": 2,
            "timeout_s": 120.0}


def test_gloo_collectives_on_cuda_tensors(card, tmp_path):
    """Two ranks on the one card: gloo takes CUDA tensors for all_reduce
    and broadcast, the port's only collectives (and its gather)."""
    from css_tpu_torch.parallel import runner

    res = runner.run({"strategy": "collectives", "world": 2,
                      "device": "cuda", "timeout_s": 60.0}, tmp_path)
    for r in res:
        assert r["backend"] == "gloo" and r["device"].startswith("cuda")
        assert r["all_reduce"] == [3.0] * 4
        assert r["broadcast"] == [1.0] * 3
        assert r["gather"] == [[0.0, 1.0], [0.0, 1.0]]


def test_dp_step_at_world_2_on_the_card(card, tmp_path):
    """Two DP ranks (4 of the 8 rows each) against one process
    on all the rows: loss 1e-5 relative, gradients rel-L2 1e-5, K3 once a
    step on each rank with no plain route, ranks bit-equal."""
    from css_tpu_torch.parallel import runner

    spec = _parallel_spec(tmp_path, 2)
    single = runner.run(dict(spec, strategy="single", world=1),
                        tmp_path / "single")[0]
    res = runner.run(spec, tmp_path / "dp")
    g1 = {k: v for k, v in single["arrays"].items() if k.startswith("grad/")}
    for r in res:
        assert r["backend"] == "gloo" and r["in_sync"]
        assert r["launches"]["stft_mag"] == 2
        assert not any(r["plain_routes"].values())
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        num = sum(float(np.sum((r["arrays"][k] - v) ** 2))
                  for k, v in g1.items())
        den = sum(float(np.sum(v ** 2)) for v in g1.values())
        assert np.sqrt(num / den) <= 1e-5


@pytest.mark.parametrize("case", ["fwd", "rev", "state", "bf16"])
def test_lstm_op_cuda_kernel_passes_opcheck(card, case):
    """torch.library.opcheck on K2's registered op with its CUDA kernel:
    schema, fake kernel, no aliasing, dispatch; every call launches."""
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    xw, w_hh = _lstm_inputs(3, 5, 64, dtype, 11, card)
    h0 = c0 = None
    if case == "state":
        h0, c0 = _carry(3, 64, dtype, 12, card)
    before, routes = (lstm_cuda.lstm_fused.launches,
                      lstm_cuda.lstm_fused.plain_routes)
    torch.library.opcheck(lstm_cuda.lstm_op,
                          (xw, w_hh, 64, case == "rev", h0, c0))
    assert lstm_cuda.lstm_fused.launches > before
    assert lstm_cuda.lstm_fused.plain_routes == routes


def test_exported_blstm_launches_k2_on_the_card(card, tmp_path):
    """A small BLSTM exported with torch.export and served from the
    artifact on the card: one K2 launch per (layer, direction), the live
    forward's masks (the same kernels on the same inputs)."""
    from css_tpu_torch.cli import export
    from css_tpu_torch.models import blstm

    conf = {"blstm_hdim": 128, "blstm_num_layers": 2}
    model = blstm.BLSTM.build_model(conf)
    model.load_state_dict(blstm.params_from_jax(blstm.init_params(7, conf)))
    program = export.export_forward(model, 4, 150, 257, card)
    torch.export.save(program, tmp_path / "b.pt2")
    served = export.load_exported(tmp_path / "b.pt2")
    f = _signal((4, 150, 257), 8, card).abs()
    before = lstm_cuda.lstm_fused.launches
    with torch.no_grad():
        got = served(f)
        torch.cuda.synchronize()
        assert lstm_cuda.lstm_fused.launches == before + 4
        want = torch.clamp(model(f)[1], max=1.0)
    assert lstm_cuda.lstm_fused.launches == before + 8
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_hop_stream_launches_k2_three_times_a_chunk(card):
    """The causal BLSTM's carried-state stream, 3 layers: each 8-frame
    chunk launches K2 once a layer through the op, and the chained chunks
    give the offline causal forward's masks (tests/test_hop_streaming.py's
    bounds)."""
    from css_tpu_torch.models import blstm

    conf = {"blstm_hdim": 128, "blstm_num_layers": 3, "blstm_causal": True}
    model = blstm.BLSTM.build_model(conf)
    model.load_state_dict(blstm.params_from_jax(blstm.init_params(9, conf)))
    model = model.to(card).eval()
    f = _signal((1, 40, 257), 10, card).abs()
    carry = model.stream_init(1)
    chunks = []
    for lo in range(0, 40, 8):
        before = lstm_cuda.lstm_fused.launches
        masks, carry = model.stream(f[:, lo:lo + 8], carry)
        assert lstm_cuda.lstm_fused.launches == before + 3
        chunks.append(masks)
    with torch.no_grad():
        want = model(f)[1]
    torch.testing.assert_close(torch.cat(chunks, dim=1), want, atol=2e-5,
                               rtol=2e-4)


def test_program_replays_count_launches_and_copy_outputs(card):
    """K3 in a program (utils/programs.py): the first call eager, the
    second captured, every replay counted once and its outputs fresh
    copies that no later replay overwrites; a capture that fails raises
    and names its program."""
    from css_tpu_torch.utils import programs

    prog = programs.Program(
        lambda x: {"mag": stft_mag_cuda.stft_mag(x * 2.0)}, "test_k3")
    xs = [_signal((3, 4096), seed, card) for seed in range(4)]
    stft_mag_cuda.stft_mag.launches = 0
    outs = [prog(x)["mag"] for x in xs]
    assert stft_mag_cuda.stft_mag.launches == len(xs)
    for x, out in zip(xs, outs):
        torch.testing.assert_close(out, stft_mag_cuda.stft_mag_plain(x * 2.0),
                                   atol=ATOL, rtol=RTOL)
    with programs.eager():
        assert torch.equal(prog(xs[-1])["mag"], outs[-1])
    assert prog.summary()["captures"] == 1
    assert prog.summary()["replays"] == len(xs) - 1

    bad = programs.Program(lambda x: x[x > 0].sum(), "test_sync")
    bad(xs[0])
    with pytest.raises(RuntimeError, match="test_sync"):
        bad(xs[0])


def test_program_spans_name_each_call_kind(card):
    """Each program call is a ``program.<name>`` span of its kind (a key's
    first call eager, its second the capture, then replays; under
    ``eager()`` direct), and the first call's and the capture's host
    seconds are the program's build seconds."""
    from css_tpu_torch.utils import programs, trace

    prog = programs.Program(lambda x: stft_mag_cuda.stft_mag(x + 1.0),
                            "test_spans")
    xs = [_signal((2, 4096), seed, card) for seed in range(4)]
    before = programs.build_seconds()
    trace.collect()
    with trace.recording():
        outs = [prog(x) for x in xs]
        with programs.eager():
            prog(xs[0])
    raw = trace.collect()["raw"]
    assert [(r["name"], r["attrs"]["kind"]) for r in raw] == [
        ("program.test_spans", k)
        for k in ("eager", "capture", "replay", "replay", "direct")]
    s = prog.summary()
    assert s["first_s"] > 0 and s["capture_s"] > 0
    assert programs.build_seconds() == pytest.approx(
        before + s["first_s"] + s["capture_s"])
    for x, out in zip(xs, outs):  # the same outputs as with tracing off
        assert torch.equal(out, prog(x))


def _conv_module(width, kernel, causal, seed, dev):
    """A Conformer ConvModule in eval on the card, every parameter and
    BatchNorm statistic drawn off its init value from a numpy seed."""
    from css_tpu_torch.models.conformer import ConvModule

    m = ConvModule(width, kernel, causal=causal)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in m.state_dict().items():
        n = rng.standard_normal(tuple(v.shape))
        if k == "bn.running_var":
            a = rng.uniform(0.1, 0.5, tuple(v.shape))
        elif k == "dw_conv.weight":
            a = n / np.sqrt(kernel)
        elif k in ("layer_norm.weight", "pw1_w", "bn.weight", "pw2_w"):
            a = 1.0 + 0.3 * n
        else:
            a = 0.3 * n
        sd[k] = torch.as_tensor(a.astype(np.float32))
    m.load_state_dict(sd)
    return m.to(dev).eval()


# case -> (B, T, C, K, causal): the separator batch of the Conformer cell,
# T not a multiple of the kernel's 16-frame tile, batch 1, causal left
# padding, and a narrow module with a short kernel
CONV_CASES = {"cell": (32, 150, 256, 33, False),
              "ragged_t": (3, 37, 256, 33, False),
              "batch1": (1, 150, 256, 33, False),
              "causal": (4, 150, 256, 33, True),
              "narrow": (2, 20, 64, 7, False)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_module_kernel_matches_plain(card, case, dtype):
    b, t, c, k, causal = CONV_CASES[case]
    m = _conv_module(c, k, causal, 1, card)
    x = (_signal((b, t, c), 2, card) * 10.0).to(dtype)
    before = ccm.conv_module.launches, ccm.conv_module.plain_routes
    with torch.no_grad():
        got = ccm.conv_module(m, x)
        torch.cuda.synchronize()
        assert (ccm.conv_module.launches,
                ccm.conv_module.plain_routes) == (before[0] + 1, before[1])
        plain = x + ccm.conv_module_plain(m, x)
        ref = x.float() + ccm.conv_module_plain(m, x.float())
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, plain, atol=2e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref, atol=1e-4,
                                   rtol=2.0 ** -8)
        own = float((plain.float() - ref).abs().max())
        gap = float((got.float() - plain.float()).abs().max())
        assert gap <= own + 2.0 ** -8 * float(ref.abs().max())


def test_conv_module_replay_is_bit_equal_to_eager(card):
    """The kernel captured in a program: every replay counted once, each
    output bit-equal to an eager call on the same input."""
    from css_tpu_torch.utils import programs

    m = _conv_module(256, 33, False, 3, card)
    prog = programs.Program(lambda x: ccm.conv_module(m, x), "test_kc")
    xs = [(_signal((32, 150, 256), s, card) * 10.0).bfloat16()
          for s in range(4)]
    before = ccm.conv_module.launches, ccm.conv_module.plain_routes
    with torch.no_grad():
        outs = [prog(x) for x in xs]
        torch.cuda.synchronize()
        assert ccm.conv_module.launches == before[0] + len(xs)
        eager = [ccm.conv_module(m, x) for x in xs]
    assert ccm.conv_module.launches == before[0] + 2 * len(xs)
    assert ccm.conv_module.plain_routes == before[1]
    assert prog.summary()["replays"] == len(xs) - 1
    for out, want in zip(outs, eager):
        assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_module_op_cuda_kernel_passes_opcheck(card, dtype):
    m = _conv_module(64, 7, True, 4, card)
    params = [p.detach() for p in ccm._params(m)]
    x = _signal((3, 21, 64), 5, card).to(dtype)
    before = ccm.conv_module.launches
    torch.library.opcheck(ccm.conv_module_op, (x, params, 6, 0, 1e-5, 1e-5))
    assert ccm.conv_module.launches > before


def test_conformer_routes_its_conv_modules_on_the_card(card):
    """A small Conformer on the card: in eval with no gradient each block
    launches the kernel; in training each block takes the plain route,
    counted; a float16 input takes it too."""
    from css_tpu_torch.models.conformer import Conformer

    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0}
    model = Conformer.build_model(conf).to(card)
    f = _signal((2, 40, 257), 6, card).abs()
    launches, routes = ccm.conv_module.launches, ccm.conv_module.plain_routes
    with torch.no_grad():
        model.eval()(f)
    assert ccm.conv_module.launches == launches + 2
    model.train()(f)[1].sum().backward()
    assert ccm.conv_module.plain_routes == routes + 2
    block = model.eval().conformer.encoders[0].conv
    with torch.no_grad():
        ccm.conv_module(block, _signal((1, 8, 64), 7, card).half())
    assert ccm.conv_module.plain_routes == routes + 3
    assert ccm.conv_module.launches == launches + 2


def test_exported_conformer_keeps_the_conv_module_op(card, tmp_path):
    """A small Conformer exported with torch.export on the card holds its
    conv modules as one css_tpu_torch::conv_module node a block (and its
    LayerNorms as four css_tpu_torch::add_layer_norm nodes a block and one
    for the embedding), and the served artifact launches the kernels as
    the live model does."""
    from css_tpu_torch.cli import export
    from css_tpu_torch.models.conformer import Conformer

    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0}
    model = Conformer.build_model(conf)
    program = export.export_forward(model, 4, 150, 257, card)
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function"
           and str(n.target).startswith("css_tpu_torch.")]
    assert [op for op in ops if "conv_module" in op] == [
        "css_tpu_torch.conv_module.default"] * 2
    assert [op for op in ops if "conv_module" not in op] == [
        "css_tpu_torch.add_layer_norm.default"] * 9
    torch.export.save(program, tmp_path / "c.pt2")
    served = export.load_exported(tmp_path / "c.pt2")
    f = _signal((4, 150, 257), 8, card).abs()
    before = ccm.conv_module.launches, aln.add_layer_norm.launches
    with torch.no_grad():
        got = served(f)
        torch.cuda.synchronize()
        assert ccm.conv_module.launches == before[0] + 2
        assert aln.add_layer_norm.launches == before[1] + 9
        want = torch.clamp(model(f)[1], max=1.0)
    assert ccm.conv_module.launches == before[0] + 4
    assert aln.add_layer_norm.launches == before[1] + 18
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_host_blocks_pin_and_copy_on_the_card(card):
    """The pipeline's host blocks (executor/host_blocks.py) on the card:
    page-locked, each asynchronous copy equal to its device stream, a held
    session's arrays intact after later sessions' copies, a short block
    replaced, a freed one reused, and a freed pool's blocks unpinned (a
    new pool pins again, at what may be the same addresses)."""
    from css_tpu_torch.executor.host_blocks import HostBlocks
    from css_tpu_torch.utils import trace

    n = 16000 * 60

    def streams(seed, length):
        g = torch.Generator(device=card).manual_seed(seed)
        return [torch.randn(length + 1000, device=card, generator=g)
                for _ in range(2)]

    def same(outs, ts, length):
        return all(np.array_equal(o, t[:length].cpu().numpy())
                   for o, t in zip(outs, ts))

    for _ in range(2):
        pool = HostBlocks()
        trace.collect()
        with trace.recording():
            short = streams(0, n // 2)
            outs = pool.to_host(short, n // 2)
            assert torch.from_numpy(outs[0].base).is_pinned()
            del outs
            first = streams(1, n)
            kept = pool.to_host(first, n)
            for seed in range(2, 6):
                s = streams(seed, n)
                outs = pool.to_host(s, n)
                assert torch.from_numpy(outs[0].base).is_pinned()
                assert same(outs, s, n)
                del outs
            assert same(kept, first, n)
        # the short block replaced, a second pinned beside the held one
        assert trace.collect()["counters"] == {"to_host_pinned": 3,
                                               "to_host_reused": 3}
        del pool, kept


def test_pipeline_streams_through_host_blocks_equal_the_pageable_copy(card):
    """CssPipeline.process on the card returns through its host blocks the
    same bits as the pageable ``.cpu()`` copy (the separator's replays on
    both sides: warmed first)."""
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.models.conformer import Conformer
    from css_tpu_torch.utils import trace

    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0}
    torch.manual_seed(0)
    pipe = CssPipeline(Conformer.build_model(conf), {
        "separation": {"batch_size": 4},
        "beamforming": {"type": "masking"}}, device=card)
    wav = (np.random.default_rng(1).standard_normal(16000 * 7) * 0.1
           ).astype(np.float32)
    for _ in range(3):
        pipe.process(wav)
    blocks, pipe.host_blocks = pipe.host_blocks, None
    plain = pipe.process(wav)
    pipe.host_blocks = blocks
    trace.collect()
    with trace.recording():
        pooled = pipe.process(wav)
    assert trace.collect()["counters"]["to_host_reused"] == 1
    assert torch.from_numpy(pooled[0].base).is_pinned()
    assert len(pooled) == len(plain) == 2
    for a, b in zip(pooled, plain):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def _layer_norm(width, seed, dev):
    """A Conformer LayerNorm in eval on the card, weight and bias drawn off
    their init from a numpy seed."""
    from css_tpu_torch.models.conformer import LayerNorm

    rng = np.random.default_rng(seed)
    ln = LayerNorm(width)
    with torch.no_grad():
        ln.weight.copy_(torch.as_tensor(
            1.0 + 0.3 * rng.standard_normal(width), dtype=torch.float32))
        ln.bias.copy_(torch.as_tensor(0.3 * rng.standard_normal(width),
                                      dtype=torch.float32))
    return ln.to(dev).eval()


def _misaligned(x):
    """x's values in a contiguous tensor whose data starts 2 elements past
    a 16-byte boundary."""
    flat = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    out = flat[2:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


# case -> (B, T, C, misaligned): the separator batch of the Conformer cells,
# odd row counts (rows not a multiple of the block's 4), the widest the plan
# takes, a width that leaves lanes idle, and a misaligned x and y
KN_CASES = {"cell": (32, 150, 256, False),
            "odd_rows": (3, 37, 256, False),
            "one_row": (1, 1, 256, False),
            "wide": (2, 21, 1024, False),
            "narrow": (5, 7, 40, False),
            "misaligned": (4, 150, 256, True)}


@pytest.mark.parametrize("with_y", [False, True], ids=["x", "x_y"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(KN_CASES))
def test_add_layer_norm_kernel_matches_plain(card, case, dtype, with_y):
    """KN once against the block's composite: the sum bit-equal to
    ``x + 0.5 * y`` in the compute dtype, the rows within KN_* of the
    composite LayerNorm of that sum, one launch and no plain route."""
    b, t, c, misaligned = KN_CASES[case]
    ln = _layer_norm(c, 1, card)
    x = (_signal((b, t, c), 2, card) * 40.0).to(dtype)
    y = (_signal((b, t, c), 3, card) * 40.0).to(dtype)
    if misaligned:
        x, y = _misaligned(x), _misaligned(y)
    before = aln.add_layer_norm.launches, aln.add_layer_norm.plain_routes
    with torch.no_grad():
        if with_y:
            r, n = aln.add_layer_norm(ln, x, y, 0.5, keep_sum=True)
            want_r = x + 0.5 * y
        else:
            n, want_r = aln.add_layer_norm(ln, x), x
        torch.cuda.synchronize()
        want = ln(want_r)
    assert (aln.add_layer_norm.launches,
            aln.add_layer_norm.plain_routes) == (before[0] + 1, before[1])
    if with_y:
        assert r.dtype == dtype and torch.equal(r, want_r)
    assert n.dtype == dtype and n.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(n, want, atol=KN_ATOL, rtol=KN_RTOL)
    else:
        torch.testing.assert_close(n.float(), want.float(),
                                   atol=KN_BF16_ATOL, rtol=KN_BF16_RTOL)


def test_add_layer_norm_without_the_sum_writes_the_same_rows(card):
    """The block's last site (the sum not kept) writes the rows the kept
    variant writes, bit for bit."""
    ln = _layer_norm(256, 4, card)
    x, y = ((_signal((32, 150, 256), s, card) * 40.0).bfloat16()
            for s in (5, 6))
    with torch.no_grad():
        _, kept = aln.add_layer_norm(ln, x, y, 0.5, keep_sum=True)
        assert torch.equal(aln.add_layer_norm(ln, x, y, 0.5), kept)


def test_add_layer_norm_replay_is_bit_equal_to_eager(card):
    """The kernel captured in a program: every replay counted once, each
    output bit-equal to an eager call on the same inputs."""
    from css_tpu_torch.utils import programs

    ln = _layer_norm(256, 7, card)
    prog = programs.Program(
        lambda x, y: aln.add_layer_norm(ln, x, y, 0.5, keep_sum=True),
        "test_kn")
    xs = [tuple((_signal((32, 150, 256), 2 * s + i, card) * 40.0).bfloat16()
                for i in range(2)) for s in range(4)]
    before = aln.add_layer_norm.launches
    with torch.no_grad():
        outs = [prog(x, y) for x, y in xs]
        torch.cuda.synchronize()
        assert aln.add_layer_norm.launches == before + len(xs)
        eager = [aln.add_layer_norm(ln, x, y, 0.5, keep_sum=True)
                 for x, y in xs]
    assert prog.summary()["replays"] == len(xs) - 1
    for out, want in zip(outs, eager):
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_add_layer_norm_op_cuda_kernel_passes_opcheck(card, dtype):
    ln = _layer_norm(64, 8, card)
    w, b = ln.weight.detach(), ln.bias.detach()
    x, y = (_signal((3, 21, 64), s, card).to(dtype) for s in (9, 10))
    before = aln.add_layer_norm.launches
    torch.library.opcheck(aln.add_layer_norm_op,
                          (x, y, 0.5, w, b, 1e-5, True))
    torch.library.opcheck(aln.add_layer_norm_op,
                          (x, None, 1.0, w, b, 1e-5, False))
    assert aln.add_layer_norm.launches > before


def test_add_layer_norm_kernel_refuses_what_it_does_not_take(card):
    ln = _layer_norm(256, 11, card)
    x = _signal((2, 20, 256), 12, card)
    with pytest.raises(ValueError):  # float16
        aln.add_layer_norm(ln, x.half())
    with pytest.raises(ValueError):  # y on another dtype
        aln.add_layer_norm(ln, x, x.bfloat16(), 0.5)
    with pytest.raises(ValueError):  # parameters off the card
        aln.add_layer_norm_op(x, None, 1.0, ln.weight.cpu(), ln.bias.cpu(),
                              1e-5, False)


def test_conformer_routes_its_layer_norms_on_the_card(card):
    """A small Conformer on the card: in eval with no gradient, four KN
    launches a block and one for the embedding, and masks within a float32
    summation order of the composite's (float32 model); in training every
    block and the embedding take the composite, counted; the hop stream
    launches none and counts nothing."""
    from css_tpu_torch.models.conformer import Conformer

    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0,
            "conformer_causal": True, "conformer_left_context": 16}
    torch.manual_seed(0)
    model = Conformer.build_model(conf).to(card)
    f = _signal((2, 40, 257), 13, card).abs()
    launches = aln.add_layer_norm.launches
    routes = aln.add_layer_norm.plain_routes
    with torch.no_grad():
        _, got = model.eval()(f)
        assert aln.add_layer_norm.launches == launches + 9
        saved = aln.takes_kernel
        aln.takes_kernel = lambda norms, x: False
        try:
            _, want = model(f)
        finally:
            aln.takes_kernel = saved
    assert aln.add_layer_norm.plain_routes == routes + 3
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    model.train()(f)[1].sum().backward()
    assert aln.add_layer_norm.plain_routes == routes + 6
    carry = model.eval().stream_init(2)
    model.stream(f[:, :8], carry)
    assert aln.add_layer_norm.launches == launches + 9
    assert aln.add_layer_norm.plain_routes == routes + 6
